#!/bin/sh
# The citation2-scale evaluation's runs on the card (PERF.md §5). Each NAME
# runs one configuration and writes $OUT/mrr_NAME.log (OUT defaults to
# results/torch_h100), headed by the card's name and power limit, the
# host's memory and cores. Run from the repository root:
#   sh results/torch_h100/run_mrr_scale.sh probe probe_fp32
#   probe       python -m surel_plus_tpu_torch.cli.probe_mrr_scale: the
#               script's 80,000 x 1001 = 80,080,000 pairs, Net(96, bf16)
#   probe_fp32  the same with --dtype float32 (the four-card run's Net)
#   md4         python3 chip_smoke.py --only multi_device: on four cards
#               the ranks over NCCL, one card each, with the probe's pairs
#               through evaluate_distributed (mesh 2 x 2 and 4 x 1)
#               against rank 0's one-card predict; it needs a machine with
#               four cards, else it runs the four ranks over gloo on one
#               card
out="${OUT:-results/torch_h100}"
mkdir -p "$out"
probe="python -m surel_plus_tpu_torch.cli.probe_mrr_scale"
status=0
for name in "$@"; do
  log="$out/mrr_$name.log"
  { nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
    free -g; echo "cores: $(nproc)"; } > "$log" 2>&1
  case "$name" in
    probe) $probe ;;
    probe_fp32) $probe --dtype float32 ;;
    md4) python3 chip_smoke.py --only multi_device ;;
    *) echo "unknown run $name"; false ;;
  esac >> "$log" 2>&1
  rc=$?
  echo "$name: exit $rc" | tee -a "$log"
  [ $rc -eq 0 ] || status=$rc
done
exit $status
