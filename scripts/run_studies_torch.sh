#!/bin/bash
# The five accuracy studies at full length on one CUDA card, in three
# lanes run side by side (the card is idle most of the time; the host
# is shared): the mapping variants at 120 frames; the aliased corridor at
# 320 frames with its positive circuit; the closure probe with and
# without loop closing, then a 200-frame TUM directory and the two
# semantic probes on it. Each study's log, and its wall seconds in
# times.txt, go to OUT (default build/studies_full).
#
#   bash scripts/run_studies_torch.sh [OUT]
cd "$(dirname "$0")/.."
O=${1:-build/studies_full}
mkdir -p "$O"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$O/card.txt"
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
run() {
  local name=$1; shift
  local t0 t1 rc
  t0=$(date +%s.%N)
  "$@" > "$O/$name.log" 2>&1
  rc=$?
  t1=$(date +%s.%N)
  echo "$name rc=$rc seconds=$(awk -v a="$t0" -v b="$t1" 'BEGIN{print b-a}')" | tee -a "$O/times.txt"
}
( run ab python3 scripts/ab_deviations_torch.py --scale 1 --frames 120 ) &
( run alias python3 scripts/diag_loop_alias_torch.py --scale 1 --frames 320 --out "$O/alias.json" ) &
( run loop python3 scripts/diag_loop_torch.py --scale 1 --frames 120
  run noloop python3 scripts/diag_loop_torch.py --scale 1 --frames 120 --no-loop
  run synth python3 scripts/make_synth_tum_torch.py --out "$O/tum200" --frames 200
  run semopt python3 scripts/diag_semopt_torch.py --seq "$O/tum200" --frames 200
  run ragged python3 scripts/diag_semopt_ragged_torch.py --seq "$O/tum200" --out "$O/ragged.json" ) &
wait
cat "$O/times.txt"
for f in "$O"/*.log; do echo "== $f"; tail -n 8 "$f" | cut -c1-600; done
