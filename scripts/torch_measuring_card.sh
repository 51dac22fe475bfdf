#!/bin/bash
# The measuring entry points of the PyTorch port on one card, from the root
# of a checkout:
#
#     bash scripts/torch_measuring_card.sh [OUT] [stage...]
#
# Stages, in this order when none is named:
#   bench     `python -m anoddpm_torch.bench` (full), its JSON line into
#             OUT/results/torch_bench.json;
#   chain     `campaigns.chain_flops`;
#   mfu       `campaigns.mfu_push` at batch 8, 16 and 32 x the norm paths
#             kernel, flax fp32, flax bf16 x remat none and dots;
#   ab        `campaigns.bf16_norm_ab` (the three paths' timings);
#   substeps  `campaigns.substep_probe` (args256syn128, 16 epochs at 4, 8
#             and 16 substeps, 2 runs each);
#   decompose `campaigns.trace_categories decompose 8 128 1` (forward loss,
#             forward + backward, the full step, 8 steps per call);
#   trace     args256syn128 trained for epochs 0 and 1 under
#             ANODDPM_PROFILE_DIR (epoch 1 traced, 16 steps), then
#             `campaigns.trace_categories trace` on that trace (kept under
#             build/measuring/prof: too large to bring back);
#   quality   `campaigns.bf16_norm_ab --quality 1` (trains and scores
#             args256syn64s2d on the flax bf16 path; the results file
#             starts as the checkout's results/torch_seed_replication.json).
#
# Everything runs under build/measuring, whose results/ is a link to
# OUT/results (build/measuring-out by default), so that the small outputs
# survive a run cut short.  Writes each stage's log, card.txt and a
# per-minute nvidia-smi record (SM clock, power draw, power limit,
# temperature) to OUT.  Where matplotlib is not installed, the stand-in under
# scripts/no_matplotlib takes its place.  Stops at the first stage that fails.
set -u
out=${1:-build/measuring-out}
shift || true
stages=${*:-bench chain mfu ab substeps decompose trace}
root=build/measuring
mkdir -p "$root/configs" "$out/results"
cp configs/args256syn64s2d.json configs/args256syn128.json "$root/configs/"
[ -e "$root/results" ] || ln -s "$(cd "$out" && pwd)/results" "$root/results"
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
mfu_matrix() {
  for b in 8 16 32; do
    for path in "1 kernel" "0 flax" "1 flax"; do
      set -- $path
      for remat in none dots; do
        python3 -m $m.mfu_push "$b" "$1" 128 1 "$remat" 1 0 "$2" --root "$root" || return
      done
    done
  done
}
for stage in $stages; do
  case $stage in
    bench) cmd=(bash -c "python3 -m anoddpm_torch.bench | tee /dev/stderr | tail -n 1 > '$out/results/torch_bench.json'") ;;
    chain) cmd=(python3 -m $m.chain_flops --root "$root") ;;
    mfu) cmd=(mfu_matrix) ;;
    ab) cmd=(python3 -m $m.bf16_norm_ab --root "$root") ;;
    substeps) cmd=(python3 -m $m.substep_probe --root "$root") ;;
    decompose) cmd=(python3 -m $m.trace_categories decompose 8 128 1) ;;
    trace) cmd=(bash -c "ANODDPM_PROFILE_DIR='$root/prof' python3 -c \"from anoddpm_torch.config import load_args; from anoddpm_torch.train import train; a = load_args('256syn128', '$root/configs'); a.update(EPOCHS=1, skip_test_eval=True, checkpoint_every=10000); train(a, root_dir='$root/trace')\" && python3 -m $m.trace_categories trace '$root/prof' 16") ;;
    quality)
      [ -e "$out/results/torch_seed_replication.json" ] || \
        cp results/torch_seed_replication.json "$out/results/"
      cmd=(python3 -m $m.bf16_norm_ab --quality 1 --root "$root") ;;
    *) echo "unknown stage $stage"; exit 2 ;;
  esac
  start=$(date +%s)
  "${cmd[@]}" > "$out/$stage.log" 2>&1
  rc=$?
  grep -v '^\[' "$out/$stage.log" | tail -n 30
  echo "stage $stage rc=$rc after $(( $(date +%s) - start )) s"
  [ $rc -eq 0 ] || exit $rc
done
