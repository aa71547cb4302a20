#!/usr/bin/env bash
# Parent / change comparison on one GPU: chip_smoke.py, then profile_ar.py
# (the fused4 AR, one row and four), then profile_nar.py at 1,200 frames
# (450 prompt + 750 generated, the bench geometry), on the per-layer int8
# route and with --mega (the decoder stack through K9), each in the order
# parent, change, change, parent, one process a run. The profilers are the
# change's, run on either tree through --root.
#
#   mkdir -p build/parent build/change
#   git archive <parent commit> | tar -x -C build/parent
#   git add -A && git archive "$(git write-tree)" | tar -x -C build/change
#   bash mars5_tts_torch/tools/parent_change.sh build/parent build/change build/parent_change
#
# Writes OUT/smoke_<n>_<parent|change>.txt, OUT/ar_<rows>_<n>_<parent|change>.txt,
# OUT/nar_1200_<n>_<parent|change>.txt and OUT/nar_mega_1200_<n>_<parent|change>.txt,
# n = 1..4 in run order; prints each run's exit code; exits 1 if any run failed.
set -u
if [ $# -ne 3 ]; then
  echo "usage: $0 PARENT_DIR CHANGE_DIR OUT_DIR" >&2
  exit 2
fi
parent=$(realpath "$1")
change=$(realpath "$2")
out=$3
mkdir -p "$out"
tools=$change/mars5_tts_torch/tools
runs="1:parent 2:change 3:change 4:parent"
rc=0

root_of() { if [ "$1" = parent ]; then echo "$parent"; else echo "$change"; fi; }

for run in $runs; do
  n=${run%%:*}; tag=${run#*:}
  (cd "$(root_of "$tag")" && python3 chip_smoke.py) > "$out/smoke_${n}_${tag}.txt" 2>&1
  r=$?; echo "smoke $n $tag rc=$r"; [ $r -eq 0 ] || rc=1
done
for rows in 1 4; do
  for run in $runs; do
    n=${run%%:*}; tag=${run#*:}
    python3 "$tools/profile_ar.py" --root "$(root_of "$tag")" --engine fused4 --rows "$rows" \
      --repeat 3 > "$out/ar_${rows}_${n}_${tag}.txt" 2>&1
    r=$?; echo "ar $rows rows $n $tag rc=$r"; [ $r -eq 0 ] || rc=1
  done
done
for run in $runs; do
  n=${run%%:*}; tag=${run#*:}
  python3 "$tools/profile_nar.py" --root "$(root_of "$tag")" --prompt 450 --gen 750 --repeat 2 \
    > "$out/nar_1200_${n}_${tag}.txt" 2>&1
  r=$?; echo "nar 1200 $n $tag rc=$r"; [ $r -eq 0 ] || rc=1
done
for run in $runs; do
  n=${run%%:*}; tag=${run#*:}
  python3 "$tools/profile_nar.py" --root "$(root_of "$tag")" --mega --prompt 450 --gen 750 \
    --repeat 2 > "$out/nar_mega_1200_${n}_${tag}.txt" 2>&1
  r=$?; echo "nar mega 1200 $n $tag rc=$r"; [ $r -eq 0 ] || rc=1
done
exit $rc
