"""Split a dry-run cell's peak live bytes by the code that made each live
storage (the innermost frames of the port), at the moment of the peak:
the op counter's ``_see`` is wrapped to remember each new storage's
creating frames.  Arguments: arch, shape, how many owners to print.

    PYTHONPATH=src python benchmarks/dryrun_owners_torch.py llama3_2_vision_90b train_4k 30
"""
import sys, traceback, collections
from repro_torch.roofline import counter as C
from repro_torch.launch.dryrun import lower_cell
made = {}
last = ["?"]
orig_d = C.OpCounter.__torch_dispatch__
def disp(self, func, types, args=(), kwargs=None):
    last[0] = str(func)
    return orig_d(self, func, types, args, kwargs)
C.OpCounter.__torch_dispatch__ = disp
snap = [0, None]
orig = C.OpCounter._see
def see(self, t, new=True):
    try:
        key = t.untyped_storage()._cdata
    except Exception:
        return orig(self, t, new)
    fresh = key not in self._storages
    before = self.peak_bytes
    orig(self, t, new)
    if fresh and key in self._storages:
        st = [f"{f.filename.split('src/')[-1].replace('repro_torch/','')}:{f.lineno}" for f in traceback.extract_stack()[:-2]
              if "repro_torch" in f.filename and "roofline" not in f.filename]
        made[key] = (tuple(t.shape), last[0], " < ".join(st[-3:][::-1]))
    if self.peak_bytes > before + 5e8:
        agg = collections.Counter()
        for k, (nb, n) in self._storages.items():
            agg[made.get(k, ((), "pre", "params/state"))[2] or "engine"] += nb
        snap[:] = [self.peak_bytes, agg]
C.OpCounter._see = see
rec = lower_cell(sys.argv[1], sys.argv[2], False, "cpu")
print(rec["status"], rec["memory"])
peak, agg = snap
print(f"snapshot at {peak/1e9:.2f} GB")
for where, nb in agg.most_common(int(sys.argv[3]) if len(sys.argv) > 3 else 25):
    print(f"  {nb/1e9:8.2f} GB  {where}")
