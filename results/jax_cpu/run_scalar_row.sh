#!/bin/bash
# The JAX package's fixture-collabs mean row with the PPR scalar encoder,
# on the CPU, through its device engine: the accuracy bar of the port's
# scalar path. The flags are the LP row's of scripts/run_jax_matrix.sh
# (20 epochs, an evaluation every 2, early stop 10, batch 4096, 3 runs)
# with --sencoder PPR (its PPR defaults: alpha 0.5, eps 1e-4, topk 100).
# Run from anywhere:
#
#   bash results/jax_cpu/run_scalar_row.sh
#
# Writes results/jax_cpu/collabs_mean_ppr.out (stdout: the best (valid,
# test) per run), .err (stderr) and .log (the run's log file, moved from
# the CLI's logs/), then summarizes the row with
# scripts/summarize_fixture_results.py. One hour at most.
set -u
cd "$(dirname "$0")/../.."
out=results/jax_cpu
name=collabs_mean_ppr
rm -rf $out/logs/$name
echo "=== $name: $(date -u +%H:%M:%S)"
start=$(date +%s)
SUREL_PLATFORM=cpu timeout 3600 python -m surel_plus_tpu.cli.main \
  --engine device --sencoder PPR --dataset fixture-collabs --aggrs mean \
  --num_walks 50 --num_steps 3 --k 10 --epochs 20 --eval_steps 2 \
  --early_stop 10 --runs 3 --batch_size 4096 --log_dir $out/logs/$name \
  > $out/$name.out 2> $out/$name.err
rc=$?
echo "=== $name done rc=$rc in $(( $(date +%s) - start )) s"
find $out/logs/$name -name '*.log' -exec mv {} $out/$name.log \; \
  && rm -r $out/logs/$name
rmdir $out/logs 2>/dev/null
python scripts/summarize_fixture_results.py $name $out/$name.log
