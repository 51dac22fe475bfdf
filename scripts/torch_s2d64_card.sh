#!/bin/bash
# The s2d64 campaigns of the PyTorch port on one card, from the root of a
# checkout:
#
#     bash scripts/torch_s2d64_card.sh [OUT] [stage...]
#
# Stages, in this order when none is named:
#   train    seed 1 of args256syn64s2d to its recipe (600 epochs),
#            `seed_replication.ensure_trained("256syn64s2d", 1)`;
#   diffuse  `campaigns.diffuse_calibration` on it (4 severities);
#   longer   `campaigns.train_longer 1 1800`: seed 1 extended to 1,800
#            epochs and scored in its three protocols;
#   dense    `campaigns.dense_sweep 25 22`: args256syn64s2d (seed 0)
#            trained, then per-lambda curves at every 25th lambda on 22
#            volumes;
#   f3       `campaigns.f3_s2d64`: that seed-0 model in three
#            seed-replication cells against the JAX package's band;
#   seeds S...  for each seed S, `campaigns.seed_replication S
#            --skip=paper128`: args256syn64s2d seed S trained to its recipe
#            (8 substeps, 600 epochs) and scored in the 9 s2d64 cells, one
#            process per seed.  OUT's results file starts as a copy of the
#            checkout's results/torch_seed_replication.json, so that the
#            aggregates cover the seeds already there.
# diffuse and longer need train's model, f3 needs dense's; nothing under
# build/ outlives a remote call, so a call runs train..longer, dense..f3 or
# seeds with the seeds it trains (two fit in a call of 3,600 s).
#
# Everything runs under build/s2d64, whose results/, metrics/ and
# final-outputs/ are links into OUT (build/s2d64-out by default), so that
# the small outputs survive a run cut short; the models stay in
# build/s2d64/model.  Writes each stage's log, card.txt and a per-minute
# nvidia-smi record (SM clock, power draw, power limit, temperature) to
# OUT.  Where matplotlib is not installed, the stand-in under
# scripts/no_matplotlib takes its place (no PNG is written) and each
# process names the plots it left out.  Stops at the first stage that fails.
set -u
out=${1:-build/s2d64-out}
shift || true
stages=(${*:-train diffuse longer dense f3})
root=build/s2d64
mkdir -p "$root/configs" "$out/results" "$out/metrics" "$out/final-outputs"
cp configs/args256syn64s2d.json "$root/configs/"
for d in results metrics final-outputs; do
  [ -e "$root/$d" ] || ln -s "$(cd "$out" && pwd)/$d" "$root/$d"
done
if ! python3 -c 'import importlib.util, sys; sys.exit(importlib.util.find_spec("matplotlib") is None)'; then
  export PYTHONPATH="$(pwd)/scripts/no_matplotlib${PYTHONPATH:+:$PYTHONPATH}"
  echo "no matplotlib: plots go to the stand-in in scripts/no_matplotlib (no PNG)"
fi
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/card.txt"
nvidia-smi --query-gpu=timestamp,clocks.sm,power.draw,power.limit,temperature.gpu \
  --format=csv,noheader --loop=60 >> "$out/smi.log" &
smi=$!
trap 'kill $smi 2>/dev/null; wait $smi 2>/dev/null' EXIT
m=anoddpm_torch.campaigns
# the seeds stage: one stage "seed<S>" per seed number after "seeds"
expanded=()
in_seeds=0
for stage in "${stages[@]}"; do
  if [ "$stage" = seeds ]; then
    in_seeds=1
  elif [ $in_seeds -eq 1 ] && [[ $stage =~ ^[0-9]+$ ]]; then
    expanded+=("seed$stage")
  else
    in_seeds=0
    expanded+=("$stage")
  fi
done
seeds_file=results/torch_seed_replication.json
for stage in "${expanded[@]}"; do
  case $stage in
    train) cmd=(python3 -c "from anoddpm_torch.campaigns.seed_replication import ensure_trained; ensure_trained('256syn64s2d', 1, '$root')") ;;
    diffuse) cmd=(python3 -m $m.diffuse_calibration --root "$root") ;;
    longer) cmd=(python3 -m $m.train_longer 1 1800 --root "$root") ;;
    dense) cmd=(python3 -m $m.dense_sweep 25 22 --root "$root") ;;
    f3) cmd=(python3 -m $m.f3_s2d64 --root "$root") ;;
    seed[0-9]*)
      [ -e "$out/$seeds_file" ] || cp "$seeds_file" "$out/$seeds_file"
      cmd=(python3 -m $m.seed_replication "${stage#seed}" --skip=paper128 --root "$root") ;;
    *) echo "unknown stage $stage"; exit 2 ;;
  esac
  start=$(date +%s)
  "${cmd[@]}" > "$out/$stage.log" 2>&1
  rc=$?
  grep -v '^\[' "$out/$stage.log" | tail -n 40
  echo "stage $stage rc=$rc after $(( $(date +%s) - start )) s"
  [ $rc -eq 0 ] || exit $rc
done
