#!/bin/bash
# The flax order of K2 and K2b against another checkout on one card, from
# the root of a checkout:
#
#     bash scripts/torch_flax_order_card.sh [OUT] [OTHER] [VARIANT] [--tests N]
#
# OTHER is a checkout to hold this one against (build/parent by default: for
# example `git archive <parent> | tar -x -C build/parent`); VARIANT, if
# given, a copy of this checkout with an edit to time against (for example
# the flax order's table read from global memory in place of shared).
# Runs, each with its log in OUT (build/flaxorder-out by default):
#   build    the kernels of this checkout, OTHER and VARIANT; the script
#            stops here if one does not build;
#   tests    the card tests (`pytest --noconftest tests/test_torch_cuda.py`)
#            N times (--tests N, 1 by default), each run's counts in OUT;
#   isa      `scripts/torch_k2_isa.py` on this checkout, OTHER and VARIANT:
#            registers, spills, SASS per loop, clusters per order and site;
#   layouts  `scripts/torch_k2_layouts.py` and `torch_k2b_layouts.py` with
#            `--root OTHER` at args256syn128's and args256syn64s2d's sites:
#            the flax order in the sites' dtype and in fp32, the kernel's
#            own order in the sites' dtype; both checkouts in turns per
#            shape, their bits compared;
#   variant  the same two scripts in the flax order with `--root VARIANT`.
# Writes card.txt (nvidia-smi's name and power limit) to OUT and a summary
# line per step; past the build, a step that fails does not stop the next.
set -u
out=${1:-build/flaxorder-out}
other=${2:-build/parent}
variant=${3:-}
tests=1
[ "${4:-}" = --tests ] && tests=${5:-1}
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/card.txt"
step() {  # name, command...: run it into OUT/name.log, print rc and tail
  local name=$1
  shift
  local start=$(date +%s)
  "$@" > "$out/$name.log" 2>&1
  local rc=$?
  echo "== $name rc=$rc after $(( $(date +%s) - start )) s"
  tail -n 3 "$out/$name.log"
  return $rc
}
roots=(. "$other")
[ -n "$variant" ] && roots+=("$variant")
i=0
for r in "${roots[@]}"; do
  step "build$i" python3 -c "import sys; sys.path.insert(0, '$r')
from anoddpm_torch.ops import _build
print(_build.__file__); _build.build()" || exit 1
  i=$((i + 1))
done
for i in $(seq 1 "$tests"); do
  step "tests$i" python3 -m pytest --noconftest -q -p no:cacheprovider \
    --maxfail 10 tests/test_torch_cuda.py
done
step isa python3 scripts/torch_k2_isa.py --root "${roots[@]}" --out "$out/isa"
configs=(--configs 256syn128 256syn64s2d)
for script in torch_k2_layouts torch_k2b_layouts; do
  for run in "flax site" "flax float32" "kernel site"; do
    set -- $run
    step "$script-$1-$2" python3 "scripts/$script.py" --order "$1" \
      --dtype "$2" "${configs[@]}" --root "$other"
  done
  if [ -n "$variant" ]; then
    step "$script-flax-variant" python3 "scripts/$script.py" --order flax \
      "${configs[@]}" --root "$variant"
  fi
done
exit 0
