#!/bin/bash
# The dry run (python -m repro_torch.launch.dryrun) of every (arch x shape)
# cell on the single-pod mesh: one process a cell, four at a time, each cut
# at CELL_S seconds (the per-token scans of rwkv6 and jamba are slow under
# fake tensors).  Run from the repository root on the card's machine (no
# --device: the fake tensors claim the card); OUT (default
# chiprun_out/dryrun_all) gets the records under single/, a log a cell,
# cells.txt (exit code and seconds a cell; 124 = cut) and card.txt.
#
#   bash benchmarks/dryrun_all_torch.sh            # CELL_S=600 OUT=... to change
export PYTHONPATH=src
export CELL_S=${CELL_S:-600} OUT=${OUT:-chiprun_out/dryrun_all}
rm -rf "$OUT"; mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > "$OUT/card.txt"
python3 -c 'import torch; print(torch.__version__)' >> "$OUT/card.txt"
cell() {
  start=$(date +%s)
  timeout -k 5 "$CELL_S" python3 -m repro_torch.launch.dryrun --arch "$1" --shape "$2" \
      --mesh single --out "$OUT" --force > "$OUT/$1__$2.log" 2>&1
  echo "$1 $2 rc=$? wall_s=$(( $(date +%s) - start ))" >> "$OUT/cells.txt"
}
export -f cell
for a in rwkv6_1_6b jamba_v0_1_52b minitron_8b qwen2_7b qwen2_5_3b qwen3_0_6b \
         qwen2_moe_a2_7b arctic_480b whisper_small llama3_2_vision_90b; do
  for s in train_4k prefill_32k decode_32k long_500k; do echo "$a $s"; done
done | xargs -P 4 -L 1 bash -c 'cell $0 $1'
sort "$OUT/cells.txt"
