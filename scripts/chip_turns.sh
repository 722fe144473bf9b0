#!/usr/bin/env bash
# Run chip_smoke.py from two checkouts in turns on one card: first,
# second, second, first (so that drift over the call shows as a
# difference between the two turns of one checkout).  Each turn's
# output, errors and ptxas report land in chiprun_out/turns/.
#
# Usage: scripts/chip_turns.sh FIRST_DIR SECOND_DIR
# (for example a `git archive` of the parent and of the change, each
# unpacked into a directory that .gitignore lists).
set -u
out=chiprun_out/turns
mkdir -p "$out"
rc=0
i=0
for d in "$1" "$2" "$2" "$1"; do
  i=$((i + 1))
  tag="turn${i}_$(basename "$d")"
  (cd "$d" && python3 chip_smoke.py) >"$out/$tag.out" 2>"$out/$tag.err" \
    || rc=1
  cp "$d/build/cuda/ptxas.log" "$out/$tag.ptxas.log" 2>/dev/null
  echo "== $tag"
  tail -n 2 "$out/$tag.out"
done
exit $rc
