#!/usr/bin/env bash
# Segmented, restart-resilient long-soak launcher.
#
# A monolithic soak loses everything past its last log line when the host
# dies and cannot resume. This runs the soak as SEGMENTS (bounded at 4 h
# each), appends a state row per finished segment (tools/soak_stitch.py),
# and on start counts the accumulated steady time from the state file — so
# re-running the SAME command after any interruption resumes toward the
# target instead of restarting. A warm-up failure with zero frames is
# retried up to twice; a segment that fails after producing frames ends the
# run.
#
# Usage: run_soak.sh <target_total_seconds> <state_dir> [end_epoch]
#   target_total_seconds: accumulated frames-flowing time to reach
#   state_dir: holds state.jsonl + seg<N>.log (survives process death)
#   end_epoch: optional absolute unix-time deadline (0/absent = none)
set -u
TARGET="${1:?target total seconds}"
DIR="${2:?state dir}"
END_EPOCH="${3:-0}"
REPO="$(cd "$(dirname "$0")/.." && pwd)"
cd "$REPO"
mkdir -p "$DIR"
STATE="$DIR/state.jsonl"
MAIN="$DIR/run_soak.log"
WARMUP_FAILS=0

deadline_hit() {
  [ "$END_EPOCH" -gt 0 ] && [ "$(date +%s)" -ge "$END_EPOCH" ]
}

while :; do
  # adopt any segment logs orphaned by a recycle (process died before its
  # state row was appended) so their steady time counts toward the target
  python tools/soak_stitch.py --reconcile "$STATE" "$DIR" >/dev/null
  ACC=$(python tools/soak_stitch.py --accumulated "$STATE")
  REMAIN=$((TARGET - ACC))
  if [ "$REMAIN" -le 0 ]; then
    echo "run_soak: target reached (${ACC}s accumulated)" >>"$MAIN"
    python tools/soak_stitch.py "$STATE" >>"$MAIN"
    exit 0
  fi
  if deadline_hit; then
    echo "run_soak: deadline with ${ACC}s accumulated (target $TARGET)" >>"$MAIN"
    python tools/soak_stitch.py "$STATE" >>"$MAIN"
    exit 2
  fi
  SEG=$(( $(ls "$DIR"/seg*.log 2>/dev/null | wc -l) + 1 ))
  LOG="$DIR/seg${SEG}.log"
  DUR=$REMAIN
  [ "$DUR" -gt 14400 ] && DUR=14400   # bound loss per recycle at 4 h
  [ "$DUR" -lt 1800 ] && DUR=1800
  if [ "$END_EPOCH" -gt 0 ]; then
    LEFT=$(( END_EPOCH - $(date +%s) ))
    [ "$DUR" -gt "$LEFT" ] && DUR=$LEFT
    [ "$DUR" -lt 600 ] && { echo "run_soak: <600s left" >>"$MAIN"; exit 2; }
  fi
  echo "run_soak: segment $SEG for ${DUR}s at $(date -u +%H:%M:%S) (acc ${ACC}s/$TARGET)" >>"$MAIN"
  env SOAK_GRACE_SECONDS=1800 python examples/soak.py "$DUR" >>"$LOG" 2>&1
  RC=$?
  python tools/soak_stitch.py --append-state "$STATE" --log "$LOG" --rc "$RC" >>"$MAIN"
  if [ "$RC" -ne 0 ]; then
    if grep -q "recent_frames=[1-9]" "$LOG"; then
      echo "run_soak: segment $SEG failed AFTER producing frames (rc=$RC) — real" >>"$MAIN"
      exit "$RC"
    fi
    WARMUP_FAILS=$((WARMUP_FAILS + 1))
    if [ "$WARMUP_FAILS" -ge 3 ]; then
      echo "run_soak: segment $SEG warm-up failure (rc=$RC, no frames); giving up" >>"$MAIN"
      exit "$RC"
    fi
    echo "run_soak: segment $SEG warm-up failure (rc=$RC, no frames); retrying" >>"$MAIN"
  else
    WARMUP_FAILS=0
  fi
done
