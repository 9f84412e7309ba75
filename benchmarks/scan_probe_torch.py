"""A probe of the chunked scans on the card: phase ``sim_benches``, the
scans held against the per-token recurrence in f32 (the largest absolute
difference), the train step of rwkv6 (24 layers) and jamba (2 of 32) at
chunk sizes 16, 32 and 64 (forward + backward, median of 4, peak GB),
then phases ``train_golden`` and ``train_families``.  Writes
``chiprun_out/probe_scans.json``.

    python3 benchmarks/scan_probe_torch.py        # on the card, ~3 minutes
"""
import json, os, sys, time
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
import torch
import chip_smoke as cs
from repro_torch.kernels import _build
from concurrent.futures import ThreadPoolExecutor

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
smi = cs.nvidia_smi()
print(smi, torch.__version__, flush=True)
with ThreadPoolExecutor(4) as pool:
    list(pool.map(lambda k: _build.build(k), cs.KERNELS))
for k in cs.KERNELS:
    _build.load(k)
res = {"card": smi}
t = time.perf_counter()
res["sim_benches"] = cs.phase_sim_benches(smi)
print("sim_benches", time.perf_counter() - t, flush=True)

# the scans: chunked against the per-token recurrence in f32 on the card,
# then the train step of rwkv6 (24 layers) and jamba (2) by chunk size
import dataclasses, statistics
from repro_torch.configs.base import get_arch
from repro_torch.models import Model, ssm
from repro_torch.train.data import DataConfig, SyntheticLM

def rwkv_ref(rh, kh, vh, wh, u, state):
    u = u[None, :, :, None]; ys = []
    for i in range(rh.shape[1]):
        kv = kh[:, i, :, :, None] * vh[:, i, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", rh[:, i], state + u * kv))
        state = wh[:, i, :, :, None] * state + kv
    return torch.stack(ys, dim=1), state

def mamba_ref(dt, bmat, cmat, xcf, a):
    b, s, d_in = xcf.shape
    h = torch.zeros(b, d_in, a.shape[1], dtype=torch.float32, device=xcf.device); ys = []
    for i in range(s):
        dt_t = dt[:, i, :, None]
        h = torch.exp(dt_t * a) * h + (dt_t * bmat[:, i, None, :]) * xcf[:, i, :, None]
        ys.append(torch.einsum("bcs,bs->bc", h, cmat[:, i]))
    return torch.stack(ys, dim=1), h

g = torch.Generator(device=dev).manual_seed(0)
def r(*shape, lo=-1.0, hi=1.0):
    return torch.rand(*shape, generator=g, device=dev) * (hi - lo) + lo
s = 3 * 32 + 5
rw = (r(2, s, 4, 64), r(2, s, 4, 64), r(2, s, 4, 64), r(2, s, 4, 64, lo=0.3, hi=1.0),
      r(4, 64, lo=-0.1, hi=0.1), r(2, 4, 64, 64, lo=-0.1, hi=0.1))
ma = (r(2, s, 64, lo=0.0, hi=0.5), r(2, s, 16), r(2, s, 16), r(2, s, 64), r(64, 16, lo=-4, hi=-0.5))
err = {}
for name, fn, ref, args in (("rwkv", ssm._rwkv_scan, rwkv_ref, rw), ("mamba", ssm._mamba_scan, mamba_ref, ma)):
    got, want = fn(*args), ref(*args)
    err[name] = max(float((a - b).abs().max()) for a, b in zip(got, want))
print("scan err vs per-token on the card", err, flush=True)
res["scan_err"] = err

def step_time(arch, layers, batch, seq, chunk, reps=4):
    ssm.SCAN_CHUNK = chunk
    cfg = get_arch(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = Model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    params = list(model.parameters())
    src = SyntheticLM(DataConfig(vocab=8192, global_batch=batch, seq_len=seq, seed=2026))
    b = {k: torch.as_tensor(v, device=dev) for k, v in src.batch(0).items()}
    torch.cuda.reset_peak_memory_stats()
    ts = []
    for i in range(reps + 1):
        torch.cuda.synchronize(); t = time.perf_counter()
        loss, _ = model.loss(b)
        torch.autograd.grad(loss, params)
        torch.cuda.synchronize(); ts.append(time.perf_counter() - t)
    out = dict(arch=arch, chunk=chunk, fwd_bwd_s=statistics.median(ts[1:]),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9, loss=float(loss))
    del model, params, loss
    torch.cuda.empty_cache()
    return out

res["chunk_sweep"] = []
for chunk in (16, 32, 64):
    for arch, layers, batch, seq in (("rwkv6_1_6b", None, 4, 256), ("jamba_v0_1_52b", 2, 4, 256)):
        o = step_time(arch, layers, batch, seq, chunk)
        print(o, flush=True)
        res["chunk_sweep"].append(o)
ssm.SCAN_CHUNK = 32

t = time.perf_counter()
res["train_golden"] = cs.phase_train_golden(dev)
print("train_golden", time.perf_counter() - t, flush=True)
t = time.perf_counter()
res["train_families"] = cs.phase_train_families(dev, smi)
print("train_families", time.perf_counter() - t, flush=True)
os.makedirs("chiprun_out", exist_ok=True)
json.dump(res, open("chiprun_out/probe_scans.json", "w"), indent=1, default=str)
print("PROBE OK")
