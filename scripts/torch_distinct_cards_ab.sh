#!/bin/bash
# 17(e) of chip_smoke.py on a machine of several cards, for the tree TREE
# (default .) with the phase's checks, then the mesh's gpu tests; unless
# MODE is "verify", then the walls of PARENT (default build/parent, a
# git archive of the parent commit) and of TREE in turns: parent, tree,
# tree, parent.  Every process's output goes to the directory OUT.
#
#   bash scripts/torch_distinct_cards_ab.sh OUT [SF] [TREE] [MODE] [PARENT]
out=$1
mkdir -p $out
sf=${2:-1}
tree=${3:-.}
mode=${4:-compare}
parent=${5:-build/parent}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > $out/smi.txt
timeout 400 python3 scripts/torch_distinct_cards_ab.py $tree change0 $sf 1 > $out/change0.log 2>&1
rc=$?
echo "change0 rc=$rc"
tail -n 5 $out/change0.log
(cd $tree && timeout 300 python3 -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q \
  -k "two_cards or four_shard or parameter_change or streamed_batches or two_threads" \
  -p no:cacheprovider) > $out/gpu_tests.log 2>&1
echo "gpu tests rc=$?"
tail -n 15 $out/gpu_tests.log
if [ $rc -ne 0 ] || [ $mode = verify ]; then
  grep -v "^mesh table" $out/change0.log | tail -n 60
  grep "^mesh table" $out/change0.log | cut -c1-3000
  exit $rc
fi
i=0
for who in parent change change parent; do
  i=$((i+1))
  dir=$tree; [ $who = parent ] && dir=$parent
  timeout 300 python3 scripts/torch_distinct_cards_ab.py $dir $who$i $sf 0 > $out/$who$i.log 2>&1
  echo "$who$i rc=$?"
  grep -h "distinct walls\|: setup\|done in" $out/$who$i.log | cut -c1-400
done
exit 0
