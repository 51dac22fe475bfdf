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
#   dense-jax  `campaigns.dense_sweep 25 22 --rng jax`: the same on the
#            JAX package's random streams (token 256syn64s2d_jaxrng, flax
#            norm order, 1 step a dispatch); its CSVs and walls under
#            OUT/results/torch_dense_sweep_jaxrng/ (pair them on the CPU
#            with `python -m anoddpm_torch.campaigns.dense_sweep --paired`);
#   roc3-jax `campaigns.roc_3way`: seed 0 of args256syn64s2d (band
#            recipe) and args256syn64s2dg trained at once on the JAX
#            package's random streams, two processes, then the 3-way pixel
#            ROC with the context encoder on diffuse lesions at severity
#            1.5; curves and walls under
#            OUT/results/torch_roc_3way_diffuse_sev1.5_jaxrng/ (pair them on
#            the CPU with `python -m anoddpm_torch.campaigns.roc_3way
#            --paired`);
#   roc3-ce-spread  the context encoder's stage of that ROC alone, 3 times
#            under each of cuDNN's default, deterministic, and deterministic
#            without TF32 (`roc_3way --ce-spread 3`; no diffusion model);
#            AUCs and walls in
#            OUT/results/torch_roc_3way_diffuse_sev1.5_jaxrng/ce_spread.json;
#   roc3-ce-mean  the context encoder's stage alone, 10 fresh runs under
#            cuDNN's default (`roc_3way --ce-mean 10`), their mean held to
#            the JAX file's CE AUC; in .../ce_default10.json;
#   model-size-jax  the JAX package's model-size token on its random
#            streams: configs/args256syn64_jaxrng.json written under the
#            run's root (`campaigns.model_size_quality --write-config
#            256syn64`: the config's own recipe, 1 step a dispatch, the
#            flax norm order, `rng: "jax"`, seed 0), trained there by the
#            train CLI (`python -m anoddpm_torch.train 256syn64_jaxrng`,
#            600 epochs), then scored in DDPM-200, DDIM-25 and DDIM-15 at
#            eta 1 (`model_size_quality 256syn64_jaxrng`), the scores in
#            OUT/results/torch_model_size_jaxrng.json (pair them on the CPU
#            with `python -m anoddpm_torch.campaigns.model_size_quality
#            --paired`); model-size-jax128 does the same for args256syn128
#            (token 256syn128_jaxrng), the control, into the same file;
#   f3       `campaigns.f3_s2d64`: that seed-0 model in three
#            seed-replication cells against the JAX package's band;
#   seeds [--flax-order] [--jax-rng] [--together] S...  for each seed S,
#            `campaigns.seed_replication S --skip=paper128`: args256syn64s2d
#            seed S trained to its recipe (8 substeps, 600 epochs) and
#            scored in the 9 s2d64 cells, one process per seed, one after
#            another.  OUT's results file starts as a copy of the
#            checkout's results/torch_seed_replication.json, so that the
#            aggregates cover the seeds already there.  --flax-order passes
#            `--norm-order flax` (the JAX package's norm order; each seed's
#            entries in its own results/torch_f3_flax_order_seeds<S>.json,
#            logs flaxorder_seed<S>.log); --jax-rng passes `--rng jax`
#            (the seeds trained and scored on the JAX package's own draws,
#            tokens 256syn64s2d_s<S>_jaxrng, in the flax order; entries in
#            results/torch_f3_jax_rng_seeds<S>.json, logs
#            jaxrng_seed<S>.log); --together starts the seeds'
#            processes at once on the one card and waits for all of them,
#            each writing its entries to a file of its own
#            (`--own-file`: results/torch_seed_replication_seeds<S>.json
#            in the default order); --paper128 (with --jax-rng) trains
#            args256syn128 in place of args256syn64s2d
#            (`--skip=s2d64,_diffuse --skip-test-eval`: the paper's band
#            recipe, 600 epochs at 8 substeps, without the test-set suite,
#            which changes no weight, scored in paper128_ddpm200 alone;
#            tokens 256syn128_s<S>_jaxrng, entries in
#            results/torch_jax_rng_256syn128_seeds<S>.json, logs
#            jaxrng128_seed<S>.log).
# A stage named with a trailing & (quote it: 'model-size-jax&') starts in
# the background, its log its own, beside the stages after it; the script
# waits for it at the end and fails if it failed.
# diffuse and longer need train's model, f3 needs dense's; nothing under
# build/ outlives a remote call, so a call runs train..longer, dense..f3 or
# seeds with the seeds it trains (two s2d64 seeds one after another fit in
# a call of 3,600 s).
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
cp configs/args256syn64s2d.json configs/args256syn64s2dg.json \
  configs/args256syn128.json configs/args256syn64.json "$root/configs/"
for d in results metrics final-outputs; do
  [ -e "$root/$d" ] || ln -s "$(cd "$out" && pwd)/$d" "$root/$d"
done
if ! python3 -c 'import importlib.util, sys; sys.exit(importlib.util.find_spec("matplotlib") is None)'; then
  export PYTHONPATH="$(pwd)/scripts/no_matplotlib${PYTHONPATH:+:$PYTHONPATH}"
  echo "no matplotlib: plots go to the stand-in in scripts/no_matplotlib (no PNG)"
fi
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/card.txt"
nvidia-smi --query-gpu=timestamp,clocks.sm,power.draw,power.limit,temperature.gpu,utilization.gpu \
  --format=csv,noheader --loop=60 >> "$out/smi.log" &
smi=$!
trap 'kill $smi 2>/dev/null; wait $smi 2>/dev/null' EXIT
m=anoddpm_torch.campaigns
here=$(pwd)
# the model-size token of config $1 on the JAX streams, trained by the
# train CLI under $root (it reads configs/ and writes model/ and metrics/
# under its working directory), then scored
model_size_stage() {
  python3 -m $m.model_size_quality --write-config "$1" --root "$root" &&
    (cd "$root" && PYTHONPATH="$here${PYTHONPATH:+:$PYTHONPATH}" \
       python3 -m anoddpm_torch.train "$1_jaxrng") &&
    python3 -m $m.model_size_quality "$1_jaxrng" --root "$root" \
      --out results/torch_model_size_jaxrng.json
}
# the stages started in the background, and their wait at the end
bg_pids=()
bg_logs=()
finish() {
  local rc=$1 i r
  for i in "${!bg_pids[@]}"; do
    wait "${bg_pids[$i]}"
    r=$?
    grep -v '^\[' "$out/${bg_logs[$i]}.log" | tail -n 40
    echo "stage ${bg_logs[$i]} (background) rc=$r"
    [ $r -eq 0 ] || rc=$r
  done
  exit $rc
}
# the seeds stage: one stage "seed<S>" per seed number after "seeds", or one
# stage "together" that runs them all at once
expanded=()
in_seeds=0
seed_order=()
seed_rng=()
seed_skip=--skip=paper128
seed_extra=()
log_prefix=
together=()
for stage in "${stages[@]}"; do
  if [ "$stage" = seeds ]; then
    in_seeds=1
  elif [ $in_seeds -eq 1 ] && [ "$stage" = --flax-order ]; then
    seed_order=(--norm-order flax)
    log_prefix=flaxorder_
  elif [ $in_seeds -eq 1 ] && [ "$stage" = --jax-rng ]; then
    seed_rng=(--rng jax)
    log_prefix=jaxrng_
  elif [ $in_seeds -eq 1 ] && [ "$stage" = --paper128 ]; then
    seed_skip=--skip=s2d64,_diffuse
    seed_extra=(--skip-test-eval)
  elif [ $in_seeds -eq 1 ] && [ "$stage" = --together ]; then
    together=(together)
    expanded+=(together)
  elif [ $in_seeds -eq 1 ] && [[ $stage =~ ^[0-9]+$ ]]; then
    if [ ${#together[@]} -gt 0 ]; then
      together+=("$stage")
    else
      expanded+=("seed$stage")
    fi
  else
    in_seeds=0
    expanded+=("$stage")
  fi
done
[ "$seed_skip" = --skip=paper128 ] || log_prefix=jaxrng128_
seeds_file=results/torch_seed_replication.json
seed_cmd() {
  [ ${#seed_order[@]} -gt 0 ] || [ -e "$out/$seeds_file" ] \
    || cp "$seeds_file" "$out/$seeds_file"
  cmd=(python3 -m $m.seed_replication "$1" "$seed_skip" "${seed_extra[@]}" "${seed_order[@]}"
       "${seed_rng[@]}" "${own_file[@]}" --root "$root")
}
own_file=()
[ ${#together[@]} -eq 0 ] || own_file=(--own-file)
for stage in "${expanded[@]}"; do
  if [ "$stage" = together ]; then
    # one process per seed, all started now; each seed's log and rc
    pids=()
    for s in "${together[@]:1}"; do
      seed_cmd "$s"
      "${cmd[@]}" > "$out/${log_prefix}seed$s.log" 2>&1 &
      pids+=($!)
    done
    start=$(date +%s)
    rc=0
    i=0
    for s in "${together[@]:1}"; do
      wait "${pids[$i]}"
      r=$?
      grep -v '^\[' "$out/${log_prefix}seed$s.log" | tail -n 12
      echo "stage ${log_prefix}seed$s rc=$r after $(( $(date +%s) - start )) s"
      [ $r -eq 0 ] || rc=$r
      i=$((i + 1))
    done
    [ $rc -eq 0 ] || finish $rc
    continue
  fi
  background=0
  if [ "${stage%&}" != "$stage" ]; then
    background=1
    stage=${stage%&}
  fi
  log=$stage
  case $stage in
    train) cmd=(python3 -c "from anoddpm_torch.campaigns.seed_replication import ensure_trained; ensure_trained('256syn64s2d', 1, '$root')") ;;
    diffuse) cmd=(python3 -m $m.diffuse_calibration --root "$root") ;;
    longer) cmd=(python3 -m $m.train_longer 1 1800 --root "$root") ;;
    dense) cmd=(python3 -m $m.dense_sweep 25 22 --root "$root") ;;
    dense-jax) cmd=(python3 -m $m.dense_sweep 25 22 --rng jax --root "$root") ;;
    roc3-jax) cmd=(python3 -m $m.roc_3way --root "$root") ;;
    roc3-ce-spread) cmd=(python3 -m $m.roc_3way --ce-spread 3 --root "$root") ;;
    roc3-ce-mean) cmd=(python3 -m $m.roc_3way --ce-mean 10 --root "$root") ;;
    f3) cmd=(python3 -m $m.f3_s2d64 --root "$root") ;;
    model-size-jax) cmd=(model_size_stage 256syn64) ;;
    model-size-jax128) cmd=(model_size_stage 256syn128) ;;
    seed[0-9]*)
      seed_cmd "${stage#seed}"
      log=$log_prefix$stage ;;
    *) echo "unknown stage $stage"; exit 2 ;;
  esac
  start=$(date +%s)
  if [ $background -eq 1 ]; then
    # its log ends with its own wall time
    ("${cmd[@]}"; r=$?
     echo "stage $log rc=$r after $(( $(date +%s) - start )) s"; exit $r) \
      > "$out/$log.log" 2>&1 &
    bg_pids+=($!)
    bg_logs+=("$log")
    echo "stage $log started in the background"
    continue
  fi
  "${cmd[@]}" > "$out/$log.log" 2>&1
  rc=$?
  grep -v '^\[' "$out/$log.log" | tail -n 40
  echo "stage $log rc=$rc after $(( $(date +%s) - start )) s"
  [ $rc -eq 0 ] || finish $rc
done
finish 0
