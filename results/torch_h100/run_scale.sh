#!/bin/sh
# The large-graph path's runs on the card (PERF.md §5). Each NAME runs one
# configuration and writes $OUT/scale_NAME.log (OUT defaults to
# results/torch_h100), headed by the card's name and power limit, the
# host's memory and cores. Run from the repository root:
#   sh results/torch_h100/run_scale.sh r05 seeds2m 1m
#   r05            SCALE_r05.md's configuration: N=10M, DRAWS=120M,
#                  SEEDS=1M, M=50, S'=3, bucket 128
#   seeds2m        the same at the JAX script's default SEEDS=2M
#   draws<D>       r05 at DRAWS=<D>
#   1m             scripts/bench_1m.py's run
#   partitioned    the partitioned mode at the JAX script's defaults
#   layout_tree    scale_layout_probe.py of this tree (r05's graph)
#   layout_parent  the same of a parent commit unpacked in _checkout/parent
out="${OUT:-results/torch_h100}"
mkdir -p "$out"
demo="python -m surel_plus_tpu_torch.cli.scale_demo"
r05="N=10000000 DRAWS=120000000 SEEDS=1000000 WALKS=50 STEPS=3 BUCKET=128"
status=0
for name in "$@"; do
  log="$out/scale_$name.log"
  { nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
    free -g; echo "cores: $(nproc)"; } > "$log" 2>&1
  case "$name" in
    r05) env $r05 $demo device ;;
    seeds2m) env $r05 SEEDS=2000000 $demo device ;;
    draws*) env $r05 DRAWS="${name#draws}" $demo device ;;
    1m) $demo 1m ;;
    partitioned) $demo partitioned ;;
    layout_tree) python results/torch_h100/scale_layout_probe.py . ;;
    layout_parent)
      python results/torch_h100/scale_layout_probe.py _checkout/parent ;;
    *) echo "unknown run $name"; false ;;
  esac >> "$log" 2>&1
  rc=$?
  echo "$name: exit $rc" | tee -a "$log"
  [ $rc -eq 0 ] || status=$rc
done
exit $status
