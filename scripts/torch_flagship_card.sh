#!/bin/bash
# The flagship quality campaign of the PyTorch port on one card, from the
# root of a checkout:
#
#     bash scripts/torch_flagship_card.sh [OUT] [epochs] [flagship options...]
#
# Trains args256syn128 to its recipe (600 epochs unless told) and scores
# it (`python -m anoddpm_torch.campaigns.flagship`) under build/campaign,
# whose results/, metrics/ and final-outputs/ are links into OUT
# (build/campaign-out by default; give a directory that a remote runner
# copies back), so that the small outputs stay apart from the model and
# survive a run cut short; the model (~1.8 GB per checkpoint) stays in
# build/campaign/model.  Writes the flagship's log and a per-minute nvidia-smi record (SM clock, power draw,
# power limit, temperature) to OUT.
set -u
out=${1:-build/campaign-out}
shift || true
root=build/campaign
mkdir -p "$root/configs" "$out/results" "$out/metrics" "$out/final-outputs"
cp configs/args256syn128.json "$root/configs/"
for d in results metrics final-outputs; do
  [ -e "$root/$d" ] || ln -s "$(cd "$out" && pwd)/$d" "$root/$d"
done
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/card.txt"
nvidia-smi --query-gpu=timestamp,clocks.sm,power.draw,power.limit,temperature.gpu \
  --format=csv,noheader --loop=60 >> "$out/smi.log" &
smi=$!
trap 'kill $smi 2>/dev/null' EXIT
start=$(date +%s)
python3 -m anoddpm_torch.campaigns.flagship --root "$root" "$@" \
  > "$out/flagship.log" 2>&1
rc=$?
grep -v '^\[' "$out/flagship.log" | tail -n 60
echo "flagship rc=$rc after $(( $(date +%s) - start )) s"
exit $rc
