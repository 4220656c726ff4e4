#!/bin/bash
# The fixture accuracy matrix of the PyTorch/CUDA port on one GPU: the
# rows of scripts/run_jax_matrix.sh, with its flags and run counts, through
# the port's CLI, and the tags fixture's HONet row (FIXTURE_RESULTS.md:72)
# through the port's higher-order CLI. Run from anywhere:
#
#   bash results/torch_h100/run_matrix.sh [ROW[@SEED] ...]  (default: the 7
#   rows of the JAX matrix; collabs_mean_ppr, the _x2 and the later
#   re-runs' rows by name)
#
# Writes, per row, results/torch_h100/<row>.out (stdout: the best (valid,
# test) per run), <row>.err (stderr) and <row>.log (the run's log file,
# which scripts/summarize_fixture_results.py reads; the CLI writes it under
# logs/<row>/, from where it is moved), then summarizes every row it ran.
set -u
cd "$(dirname "$0")/../.."
out=results/torch_h100
mkdir -p $out

nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)'
# every kernel built before the first row (one nvcc a source, together),
# so that no row's training time holds a build
python -c 'from surel_plus_tpu_torch.ops.kernels import build
build.build_all(sorted(p.stem for p in build.CSRC.glob("*.cu")))'

declare -A ARGS=(
  [collabs_mean]="--dataset fixture-collabs --aggrs mean --num_walks 50 --num_steps 3 --k 10 --epochs 20 --eval_steps 2 --early_stop 10 --runs 3 --batch_size 4096"
  [collabs_attn]="--dataset fixture-collabs --aggrs attn --num_walks 50 --num_steps 3 --k 10 --epochs 20 --eval_steps 2 --early_stop 10 --runs 6 --batch_size 4096"
  [collabs_lstm]="--dataset fixture-collabs --aggrs lstm --num_walks 20 --num_steps 3 --k 5 --epochs 12 --eval_steps 2 --early_stop 10 --runs 3 --batch_size 1024"
  [collab_mean]="--dataset fixture-collab --aggrs mean --num_walks 200 --num_steps 3 --k 10 --epochs 30 --eval_steps 2 --early_stop 10 --runs 3 --batch_size 4096"
  [collab_attn]="--dataset fixture-collab --aggrs attn --num_walks 200 --num_steps 3 --k 10 --epochs 30 --eval_steps 2 --early_stop 10 --runs 3 --batch_size 4096"
  [cites_mean]="--dataset fixture-cites --aggrs mean --num_walks 50 --num_steps 3 --k 10 --epochs 16 --eval_steps 2 --early_stop 10 --runs 3 --batch_size 4096"
  # JAX's command for this row is on record only in part (FIXTURE_RESULTS.md:72:
  # 12 epochs, M=50, k=10, batch 4096, --valid_perc 25, 3 runs);
  # --num_steps 3, --eval_steps 2 and --early_stop 10 are the other rows'
  [tags_honet]="--dataset npz:surel_plus_tpu/data/fixtures/tags_fixture.npz --num_walks 50 --num_steps 3 --k 10 --epochs 12 --eval_steps 2 --early_stop 10 --runs 3 --batch_size 4096 --valid_perc 25"
  # collabs mean with the PPR scalar encoder: the bar is the JAX package's
  # CPU run of the same flags, results/jax_cpu/run_scalar_row.sh
  [collabs_mean_ppr]="--dataset fixture-collabs --aggrs mean --sencoder PPR --num_walks 50 --num_steps 3 --k 10 --epochs 20 --eval_steps 2 --early_stop 10 --runs 3 --batch_size 4096"
  # a row re-run with twice its runs, named only on the command line
  [collabs_attn_x2]="--dataset fixture-collabs --aggrs attn --num_walks 50 --num_steps 3 --k 10 --epochs 20 --eval_steps 2 --early_stop 10 --runs 12 --batch_size 4096"
  [cites_mean_x2]="--dataset fixture-cites --aggrs mean --num_walks 50 --num_steps 3 --k 10 --epochs 16 --eval_steps 2 --early_stop 10 --runs 6 --batch_size 4096"
  # the two rows outside their bands, re-run once the samplers' first hop
  # read the native per-row shuffle (the JAX package's), named only on the
  # command line; the earlier rows' files stay as they were
  [collabs_attn_native]="--dataset fixture-collabs --aggrs attn --num_walks 50 --num_steps 3 --k 10 --epochs 20 --eval_steps 2 --early_stop 10 --runs 6 --batch_size 4096"
  [cites_mean_native]="--dataset fixture-cites --aggrs mean --num_walks 50 --num_steps 3 --k 10 --epochs 16 --eval_steps 2 --early_stop 10 --runs 3 --batch_size 4096"
  # the rows outside their bands at one seed, re-run once the port drew
  # from the JAX package's key tree (the sets, batch orders and dropout
  # masks JAX draws), named only on the command line (tags at its missed
  # seed: tags_honet_threefry@1)
  [collabs_attn_threefry]="--dataset fixture-collabs --aggrs attn --num_walks 50 --num_steps 3 --k 10 --epochs 20 --eval_steps 2 --early_stop 10 --runs 6 --batch_size 4096"
  [cites_mean_threefry]="--dataset fixture-cites --aggrs mean --num_walks 50 --num_steps 3 --k 10 --epochs 16 --eval_steps 2 --early_stop 10 --runs 3 --batch_size 4096"
  [tags_honet_threefry]="--dataset npz:surel_plus_tpu/data/fixtures/tags_fixture.npz --num_walks 50 --num_steps 3 --k 10 --epochs 12 --eval_steps 2 --early_stop 10 --runs 3 --batch_size 4096 --valid_perc 25"
  # the seven rows re-run once the port drew its initial weights as
  # flax's init does from JAX's key tree (--seed 0: the weights JAX's rows
  # start from), named only on the command line: keyinit
  [collabs_mean_keyinit]="--dataset fixture-collabs --aggrs mean --num_walks 50 --num_steps 3 --k 10 --epochs 20 --eval_steps 2 --early_stop 10 --runs 3 --batch_size 4096 --seed 0"
  [collabs_attn_keyinit]="--dataset fixture-collabs --aggrs attn --num_walks 50 --num_steps 3 --k 10 --epochs 20 --eval_steps 2 --early_stop 10 --runs 6 --batch_size 4096 --seed 0"
  [collabs_lstm_keyinit]="--dataset fixture-collabs --aggrs lstm --num_walks 20 --num_steps 3 --k 5 --epochs 12 --eval_steps 2 --early_stop 10 --runs 3 --batch_size 1024 --seed 0"
  [collab_mean_keyinit]="--dataset fixture-collab --aggrs mean --num_walks 200 --num_steps 3 --k 10 --epochs 30 --eval_steps 2 --early_stop 10 --runs 3 --batch_size 4096 --seed 0"
  [collab_attn_keyinit]="--dataset fixture-collab --aggrs attn --num_walks 200 --num_steps 3 --k 10 --epochs 30 --eval_steps 2 --early_stop 10 --runs 3 --batch_size 4096 --seed 0"
  [cites_mean_keyinit]="--dataset fixture-cites --aggrs mean --num_walks 50 --num_steps 3 --k 10 --epochs 16 --eval_steps 2 --early_stop 10 --runs 3 --batch_size 4096 --seed 0"
  [tags_honet_keyinit]="--dataset npz:surel_plus_tpu/data/fixtures/tags_fixture.npz --num_walks 50 --num_steps 3 --k 10 --epochs 12 --eval_steps 2 --early_stop 10 --runs 3 --batch_size 4096 --valid_perc 25 --seed 0"
)
# the CLI of each row: link prediction, or higher-order prediction
declare -A CLI=([tags_honet]=surel_plus_tpu_torch.cli.main_horder
                [tags_honet_threefry]=surel_plus_tpu_torch.cli.main_horder
                [tags_honet_keyinit]=surel_plus_tpu_torch.cli.main_horder)
ROWS=("$@")
[ ${#ROWS[@]} -eq 0 ] && ROWS=(collabs_mean collabs_attn collabs_lstm collab_mean collab_attn cites_mean tags_honet)

# ROW@S runs ROW with --seed S (its data prep, sets, weights and batch
# orders all from S) and names its files ROW_seedS
NAMES=()
for row in "${ROWS[@]}"; do
  base=${row%@*}
  args=${ARGS[$base]}
  name=$base
  if [ "$base" != "$row" ]; then
    args="$args --seed ${row#*@}"
    name=${base}_seed${row#*@}
  fi
  NAMES+=("$name")
  cli=${CLI[$base]:-surel_plus_tpu_torch.cli.main}
  echo "=== $name: $(date -u +%H:%M:%S) python -m $cli $args --log_dir $out/logs/$name"
  rm -rf $out/logs/$name
  start=$(date +%s%N)
  python -m $cli $args --log_dir $out/logs/$name \
    > $out/$name.out 2> $out/$name.err
  rc=$?
  ms=$(( ($(date +%s%N) - start) / 1000000 ))
  # the log sits under logs/<row>/<dataset>/, the dataset a path for npz:
  find $out/logs/$name -name '*.log' -exec mv {} $out/$name.log \; \
    && rm -r $out/logs/$name
  echo "=== $name done rc=$rc in $ms ms ($out/$name.log)"
  tail -n 3 $out/$name.err
  grep -h "phase" $out/$name.log | sed 's/.* - INFO - /  /'
done
rmdir $out/logs 2>/dev/null
for name in "${NAMES[@]}"; do
  python scripts/summarize_fixture_results.py $name $out/$name.log
done
