#!/bin/bash
# The eight tracking-retention probes at their default lengths on one CUDA
# card, in three lanes run side by side (the card is idle most of the
# time; the host is shared): a 60-frame KITTI street directory
# (make_synth_kitti_torch.py), then diag_kitti (60 frames); diag_kitti_
# retention and diag_local_recovery (40 each); diag_motion_chain (30),
# diag_retention at TUM VGA (30, OSLAM_DUMP on), diag_poseopt, and
# diag_replay / diag_gnsteps on the retention run's first dump when it
# wrote one. Each probe's log, and its wall seconds in times.txt, go to
# OUT (default build/probes_full).
#
#   bash scripts/run_probes_torch.sh [OUT]
cd "$(dirname "$0")/.."
O=${1:-build/probes_full}
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
run synth python3 scripts/make_synth_kitti_torch.py --out "$O/kitti" --frames 60
S="$O/kitti"
( run kitti python3 scripts/diag_kitti_torch.py --seq "$S" --frames 60 ) &
( run kitti_retention python3 scripts/diag_kitti_retention_torch.py --seq "$S" --frames 40
  run local_recovery python3 scripts/diag_local_recovery_torch.py --seq "$S" --frames 40 --out "$O/local_recovery.json" ) &
( run motion_chain python3 scripts/diag_motion_chain_torch.py --seq "$S" --frames 30 --out "$O/motion_chain.json"
  OSLAM_DUMP="$O/dumps" run retention python3 scripts/diag_retention_torch.py --frames 30
  run poseopt python3 scripts/diag_poseopt_torch.py
  D=$(ls "$O"/dumps/f*.npz 2>/dev/null | head -n 1)
  if [ -n "$D" ]; then
    run replay python3 scripts/diag_replay_torch.py "$D"
    run gnsteps python3 scripts/diag_gnsteps_torch.py "$D"
  fi ) &
wait
cat "$O/times.txt"
for f in "$O"/*.log; do echo "== $f"; tail -n 14 "$f" | cut -c1-400; done
