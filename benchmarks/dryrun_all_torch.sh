#!/bin/bash
# The dry run (python -m repro_torch.launch.dryrun) of every (arch x shape)
# cell on one mesh, single (16x16, the default) or multi (2x16x16): one
# process a cell, four at a time, each cut at CELL_S seconds (rwkv6's and
# jamba's chunked scans take a few ops a chunk of 32 tokens under fake
# tensors).  Run from the repository root on the card's machine (no
# --device: the fake tensors claim the card); OUT (default
# chiprun_out/dryrun_all) gets the records under <mesh>/, as the dry run
# writes them, and under logs_<mesh>/ a log a cell, cells.txt (exit code and
# seconds a cell; 124 = cut), card.txt and summary.txt (a line a cell:
# FLOPs a rank, peak bytes a rank, the roofline terms).
#
#   bash benchmarks/dryrun_all_torch.sh [single|multi]   # CELL_S=600 OUT=... to change
export PYTHONPATH=src
export MESH=${1:-single}
case "$MESH" in single|multi) ;; *) echo "error: mesh $MESH is not single or multi" >&2; exit 2;; esac
export CELL_S=${CELL_S:-600} OUT=${OUT:-chiprun_out/dryrun_all}
export LOGS="$OUT/logs_$MESH"
rm -rf "${OUT:?}/$MESH" "$LOGS"; mkdir -p "$LOGS"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > "$LOGS/card.txt"
python3 -c 'import torch; print(torch.__version__)' >> "$LOGS/card.txt"
cell() {
  start=$(date +%s)
  timeout -k 5 "$CELL_S" python3 -m repro_torch.launch.dryrun --arch "$1" --shape "$2" \
      --mesh "$MESH" --out "$OUT" --force > "$LOGS/$1__$2.log" 2>&1
  echo "$1 $2 rc=$? wall_s=$(( $(date +%s) - start ))" >> "$LOGS/cells.txt"
}
export -f cell
for a in rwkv6_1_6b jamba_v0_1_52b minitron_8b qwen2_7b qwen2_5_3b qwen3_0_6b \
         qwen2_moe_a2_7b arctic_480b whisper_small llama3_2_vision_90b; do
  for s in train_4k prefill_32k decode_32k long_500k; do echo "$a $s"; done
done | xargs -P 4 -L 1 bash -c 'cell $0 $1'
sort "$LOGS/cells.txt"
python3 - "$OUT/$MESH" > "$LOGS/summary.txt" <<'PY'
import json, os, sys
for fn in sorted(os.listdir(sys.argv[1])):
    r = json.load(open(os.path.join(sys.argv[1], fn)))
    if r["status"] != "ok":
        print(r["arch"], r["shape"], r["status"])
        continue
    t = r["roofline"]
    print(r["arch"], r["shape"], r["mesh"], f"tflop={r['op_analysis']['flops_per_device'] / 1e12!r}",
          f"peak_gb={r['memory']['peak_bytes'] / 1e9!r}", f"compute_ms={t['compute_s'] * 1e3!r}",
          f"memory_ms={t['memory_s'] * 1e3!r}", f"collective_ms={t['collective_s'] * 1e3!r}",
          f"dominant={t['dominant']}", f"run_s={r['run_s']!r}")
PY
cat "$LOGS/summary.txt"
