"""Times full-width qwen3_0_6b train steps (bf16, remat, 8 x 1,024 tokens:
loss + gradients, no update; the median of steps 3..8) with the
repro_torch of the tree given, and prints one JSON line.  To compare two
commits in one call, unpack the other with ``git archive <rev> | tar -x
-C build/base`` and alternate them:

    for t in build/base . . build/base; do python3 benchmarks/train_ab_torch.py $t; done
"""
import json, os, statistics, sys, time
root = sys.argv[1]
sys.path.insert(0, os.path.join(root, "src"))
import torch
from repro_torch.configs.base import get_arch
from repro_torch.models import Model
from repro_torch.train.data import DataConfig, SyntheticLM
dev = torch.device("cuda")
model = Model(get_arch("qwen3_0_6b")).init(torch.Generator(device=dev).manual_seed(0))
params = list(model.parameters())
src = SyntheticLM(DataConfig(vocab=8192, global_batch=8, seq_len=1024, seed=2026))
batch = {k: torch.as_tensor(v, device=dev) for k, v in src.batch(0).items()}
ts = []
torch.cuda.reset_peak_memory_stats()
for i in range(8):
    torch.cuda.synchronize(); t = time.perf_counter()
    loss, _ = model.loss(batch)
    grads = torch.autograd.grad(loss, params)
    torch.cuda.synchronize(); ts.append(time.perf_counter() - t)
    del grads
print(json.dumps(dict(tree=root, fwd_bwd_s=statistics.median(ts[2:]), all_s=ts,
                      peak_gb=torch.cuda.max_memory_allocated() / 1e9, loss=float(loss))), flush=True)
