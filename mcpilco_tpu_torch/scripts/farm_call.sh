#!/bin/bash
# One time-limited part of a farm batch that takes more than one run, as
# `repeat --farm --resume` resumes it from its lanes' complete_trial<i>.
#
#   bash mcpilco_tpu_torch/scripts/farm_call.sh OUT WATCH_TRIAL SCENARIO FIRST_SEED NUM_SEEDS
#
# Runs, from the checkout's root,
#   python -m mcpilco_tpu_torch.scripts.repeat --scenario SCENARIO \
#       --first-seed FIRST_SEED --num-seeds NUM_SEEDS --farm-batch NUM_SEEDS --resume
# cut SWEEP_END seconds (default 3470) after this script started.  With
# WATCH_TRIAL >= 0 it drops the sweep's STOP file STOP_DELAY seconds (default
# 60) after every seed's log dir holds complete_trial<WATCH_TRIAL>, so the
# batch ends cleanly at the boundary after the next trial: give it the trial
# before the last one that fits in the run.  -1 drops no STOP file.  SMOKE_FIRST=1 first runs the
# scenario's 2-seed --smoke farm leg and keeps its output apart.  Writes the
# card's name and power limit, the exit codes and the sweep's log to OUT, and
# copies the seeds' log dirs (lane checkpoints, stdout.log) and the summary
# to OUT/torch; copy those into results_tmp/torch/ before the next part.
# REPEAT_FLAGS, if set, is added to both repeat commands (e.g. "--device cpu").
# OUT_TAG, if set, is the sweep's --out-tag: its seeds' log dirs are
# SCENARIO_OUT_TAG_<seed>, its summary repeat_SCENARIO_OUT_TAG.json and its STOP
# file repeat_SCENARIO_OUT_TAG.STOP, so that another sweep's stay as they are.
START=$(date +%s)
OUT=$1; WATCH_T=$2; SCEN=$3; FIRST=$4; NUM=$5
LAST=$(( FIRST + NUM - 1 ))
DIR=results_tmp/torch
RUN=$SCEN${OUT_TAG:+_$OUT_TAG}
TAG_FLAG=${OUT_TAG:+--out-tag $OUT_TAG}
mkdir -p "$OUT" "$DIR"
date -u
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
ls "$DIR"
if [ "${SMOKE_FIRST:-0}" = 1 ]; then
  mkdir -p "$OUT/smoke"
  t0=$(date +%s)
  timeout 900 python -u -m mcpilco_tpu_torch.scripts.repeat --scenario "$SCEN" --smoke \
      --num-seeds 2 --farm-batch 2 $REPEAT_FLAGS > "$OUT/smoke/console.log" 2>&1
  echo "smoke rc=$? after $(( $(date +%s) - t0 )) s" | tee "$OUT/smoke/rc.txt"
  tail -15 "$OUT/smoke/console.log"
  cp -r "$DIR/${SCEN}_1" "$DIR/${SCEN}_2" "$DIR/repeat_${SCEN}.json" "$OUT/smoke/" 2>/dev/null
  rm -rf "$DIR/${SCEN}_1" "$DIR/${SCEN}_2" "$DIR/repeat_${SCEN}.json"
fi
STOPF=$DIR/repeat_${RUN}.STOP
WATCHER=
if [ "$WATCH_T" -ge 0 ]; then
  ( while true; do
      n=0
      for s in $(seq "$FIRST" "$LAST"); do
        [ -f "$DIR/${RUN}_$s/complete_trial$WATCH_T/manifest.json" ] && n=$(( n + 1 ))
      done
      if [ "$n" = "$NUM" ]; then
        sleep "${STOP_DELAY:-60}"; touch "$STOPF"; echo "STOP dropped at $(date -u)"; break
      fi
      sleep 10
    done ) &
  WATCHER=$!
fi
LIMIT=$(( ${SWEEP_END:-3470} - ($(date +%s) - START) ))
echo "sweep limit $LIMIT s"
t0=$(date +%s)
timeout -k 20 "$LIMIT" python -u -m mcpilco_tpu_torch.scripts.repeat --scenario "$SCEN" \
    --first-seed "$FIRST" --num-seeds "$NUM" --farm-batch "$NUM" --resume $TAG_FLAG $REPEAT_FLAGS \
    > "$OUT/sweep.log" 2>&1
echo "sweep rc=$? after $(( $(date +%s) - t0 )) s" | tee "$OUT/rc.txt"
[ -n "$WATCHER" ] && kill "$WATCHER" 2>/dev/null
rm -f "$STOPF"
mkdir -p "$OUT/torch"
for s in $(seq "$FIRST" "$LAST"); do cp -r "$DIR/${RUN}_$s" "$OUT/torch/" 2>/dev/null; done
cp "$DIR/repeat_${RUN}.json" "$OUT/torch/" 2>/dev/null
du -sh "$OUT"
grep -v "^ " "$OUT/sweep.log" | tail -60
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
date -u
