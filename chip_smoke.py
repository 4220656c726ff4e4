"""Smoke run of the PyTorch/CUDA port (`surel_plus_tpu_torch`) on one
NVIDIA GPU. Run from the repository root:

    python3 chip_smoke.py

1. Builds the thirteen CUDA kernels from `surel_plus_tpu_torch/csrc/` (one
   nvcc per source, started together) and prints the build time, each
   source's registers and spills, and ptxas's lines for every instance of
   the set sum (K1) and the two hidden-layer backwards.
2. Holds each kernel against its plain PyTorch version on the card, on
   sets sampled from the main path's graph at the main path's shapes:
   first the threefry words (K8, `threefry_vs_plain`): Random123's and
   JAX's known answers (constants), the kernel bit for bit against its
   plain version at 1, 1023, 4097 and 6,553,600 words (a sampler block's
   step draw) and across 2^32, the sets of a 4,000-node graph sampled on
   the card against the port's CPU sets (exactly: the tests hold those
   to JAX's), its time beside its bound (integer operations at
   INT32_OPS_PER_S against the words written) and the main path's walk
   draws beside `torch.randint` of the same shapes; then the fused key
   hidden set sum (K1) in the lo-only layout (M=100, S'=3,
   L=301) and the lead-in-hi layout (M=200, S'=4, L=801), at Q=4 with
   odd B, L and Lc, on seeded keys at H=100, H=1024, ncol=8 and shift 12
   (with the root bit and with root planes), and on weights that put z at
   or within a few ulps of 0 at many slots (`near_zero_u`: the tensor-core
   z's recheck in the fmaf order), fp32 at rtol 1e-4 / atol 1e-3, two
   launches bit for bit, an all-masked set exactly 0, and on those
   weights with one selected slot a set, its relu decisions (out > 0)
   exactly those of the fmaf order (`k1_decisions`); its backward (K1
   bwd) in both layouts, at a
   small Q=4 shape with an all-masked set and on seeded keys at H=100,
   H=1024, ncol=8 and shift 12 (fields past TF32's exact range, with the
   root bit and with root planes), fp32 within 1e-4 of each dU row's
   largest magnitude, its masking row exactly 0, and two launches bit for
   bit; the attention
   pool (K3) and its backward (K3 bwd) in both layouts, at an odd shape
   (B=999, L=203), at Q=4, in both layouts on rows of every mask kind
   the kernels' walk over valid slots must keep (holes spanning whole
   32-slot tiles, valid slots only in the last tile, only slot 0,
   none), and at the longest L the wrappers take at H=96 (two sets, one
   warp's block of shared memory full), the pooled rows and the softmax
   residuals at rtol = atol = 1e-4, dU within 1e-4 of each row's
   largest magnitude and dgvec, dgconst (sums that cancel) within 1e-6
   of their terms' sizes, two launches of each bit for bit; the
   keys-LSTM (K4) in both layouts (L=301 and L=801), at an odd shape
   (B=999, L=203), at Q=4, on masks with holes punched in, with an empty row and a row
   valid only at its last slot, and at H=256 (its widest, with the
   weights read from L2), fp32 at rtol = atol = 1e-4, two launches,
   the unsorted row order and the training instance (which keeps the
   stash for the backward) bit for bit, the empty row exactly 0; its
   backward (K4 bwd, from the training forward's stash) on the same
   seven cases, each gradient within 1e-4 of its largest entry with the
   rows sorted and unsorted, two launches bit for bit, dU's masking row
   exactly 0 and empty rows silent; the
   merge (K2) at [4096, 301] x 2, at [4096, 801] x 2, at odd widths, on
   rows of many equal keys across a and b (all equal among them), at
   la = 1 and at la + lb = MAX_ROW, exactly, two launches bit for bit,
   and its launch times' spread (`launch_spread`: flushed by zeroing or
   by reading, the outputs allocated once, and back to back); the masked LSTM over given rows (K5) on the encoding-table
   path's real input (the pair-summed hidden rows of a table join, fp32
   [8192, L, 96], with the join's prefix masks) at (a) L=301 and (b)
   L=801, (c) at B=999, L=203, (d) on masks with holes, (e) with an
   empty row and a row valid only at its last slot, and (f) at
   h = H = 256, fp32 at rtol = atol = 1e-4, two launches, the unsorted
   row order and the training instance bit for bit, the empty row
   exactly 0; its backward (K5 bwd, from the training forward's stash)
   on the same six cases, each of dx, dwi, dwh, dbh within 1e-4
   of its largest entry with the rows sorted and unsorted, two launches
   bit for bit, dx exactly 0 at every masked slot and empty rows silent;
   the cross lookup of both key words in both directions of a join, one
   launch (K6), exactly against its plain version (the [B, L, L]
   equality mask) in both directions, two launches bit for bit, on rows
   checked ascending on the card (the kernel's precondition): the join
   rows of the lo-only [4096, 301] and lead-in-hi [4096, 801] batches
   and of sets in the general hi/lo layout (M=1000, S'=4, 4096 seeds of
   the graph: [2048, 4001]), at odd B and L, with full 32-bit payload
   words, on rows whose nodes repeat, rows of padding only, rows with no
   common node and at L=1, timed at the three join shapes as issued and
   queued (`launch_spread`); the per-slot hidden rows from the keys (K7) on the lo-only
   [2, 4096, 301] batch with fp32 and bf16 output, the lead-in-hi
   [2, 4096, 801] batch with root planes (both outputs), at B=999, L=203
   and at Q=4, fp32 at rtol = atol = 1e-5 and bf16 within one bf16
   rounding; its backward (K7 bwd) on the same shapes and the seeded
   ones of K1 bwd with a bf16 and a fp32 cotangent, dU within 1e-4 of
   each row's largest magnitude, its masking row exactly 0, two launches
   bit for bit. Times each kernel,
   its plain version and, as yardsticks, `torch.sort` for the merge,
   cuDNN's LSTM (`torch.nn.LSTM` over the packed rows: the recurrence
   alone) forward for K4 and K5, and its training forward and backward
   beside K4 bwd and K5 bwd (each backward timed alone from a fresh
   stash, beside its training forward and the pair, at L=301 and
   L=801, with its bound on the fp32 CUDA cores and its products' time
   in 3xTF32 at the TF32 tensor rate; each forward's serving and
   training instance beside cuDNN's forward and training forward, with
   both bounds, the longest block's step count and the blocks an SM
   holds), holds each LSTM autograd Function's gradients with its
   training stash split into row groups (the stash budget lowered) to
   the whole stash's (within 1e-4 of each tensor's largest), the
   merge route's cross lookup and the `torch.searchsorted` lookup for
   K6, and for K7 and K7 bwd the
   feature-pair route they replace (the join's unpack, the hidden layer
   and the pair sum in bf16, and its backward); K1's bound as the larger
   of its bytes, its CUDA-core operations and its products at the TF32
   tensor rate (`k1_tc_ms`), beside the first version's fp32 bound; K1
   bwd's and K7 bwd's bounds also with their dU contraction at the TF32
   tensor rate; and prints the phase's peak device memory.
3. Draws the weights from JAX's key tree on the card (`init_from_key`):
   Net(96, bf16) mean, attn and lstm, HONet(96) and the LSTM's
   torch_init uniform from prng_key(0), each against the port's CPU
   init from the same key (the tests hold that to flax's `init`): every
   xavier parameter's truncation uniforms bit for bit, every parameter
   within 4 ulp, no xavier weight beyond 2.2737 of its sigma; per model
   the bit-equal share, the largest |w| / sigma and the K8 launches of
   the init (counted as the `init_from_key` path, one a drawn
   parameter). Every model below is drawn so, each trainer's `init`
   from a key.
   Then drives the serving path at the bench width: an RMAT graph of 250k
   nodes and 2.5M generated edges, `sample_gsets_device_keys` (M=100,
   S'=3; cold on a fresh graph object, the upload, shuffle and int32
   edge-table build timed apart on another, then warm),
   `Net(96, mean, bfloat16)` from prng_key(0), `predict` on
   32 x 4096 query edges, then the MRR of 4096 sources against 1000
   negatives each. Checks the sets' invariants, the fused route's logits
   against the plain route's (unfused, over the feature pairs) on one
   batch (bf16, rtol = atol = 5e-2), and the card against the port's CPU path on 256 queries (fp32
   scores, rtol = atol = 1e-4). Profiles a few predict batches (device
   time by kernel, the device time a step, and the device's busy share).
   Then drives the training path at the bench width (bench.py:153-186):
   `DeviceTrainer.fit` over 32 x 4096 random query edges with random 0/1
   labels, lr 1e-3, grad_clip 1.0, one cold 8-epoch fit (which must make
   no synchronizing CUDA call) and a timed one. Checks the fused route's
   parameter gradients against the plain route's on one batch at the
   initial weights (fp32 with random labels within 1e-3, bf16 with
   all-one labels and bf16 with a random cotangent on the scorer's input
   within 5e-2, of each tensor's largest gradient; the two loss
   gradients less the queries whose scorer relu decisions the routes
   part within rounding of 0, at most 4 in fp32 and half the batch in
   bf16, check_train_routes says why), the fit's losses and AUCs,
   that the parameters moved, and a few training steps on the card
   against the port's CPU path on 256 queries (fp32, dropout 0, the same
   permutation; parameters at rtol 1e-4, atol 1e-5). Profiles a few
   train steps.
   Then the attention path, bench.py:203-234 on the same sets:
   `Net(96, attn, dropout 0.1, bfloat16)` from prng_key(0),
   `predict` on the 32 x 4096 edges, a cold 4-epoch fit (no synchronizing
   call), a timed 4-epoch fit, a timed `predict`, and the same route,
   gradient and card-vs-CPU checks. The attention gate's bias has a
   gradient of 0 up to rounding
   (the softmax does not move when all gates of a set do), so that
   tensor is held to absolute bounds (GATE_BIAS_*). Profiles a few
   attention predict batches and train steps.
   Then the LSTM paths, bench.py:206-231 on the same sets:
   `Net(96, lstm, dropout 0.1, bfloat16)` from prng_key(0), a
   cold and a timed `predict` on the 32 x 4096 edges, the route checks,
   a cold 4-epoch fit (no synchronizing call), a timed 4-epoch fit, a
   timed `predict`, the same route, gradient and card-vs-CPU checks, and
   profiles of a few predict batches and train steps.
   Then the encoding-table path on the same graph: `sample_gsets_device`
   (M=100, S'=3) cold (a fresh row shuffle) and warm with the keys
   sampler's seed, whose nodes and sizes must equal the keys sampler's
   and whose table rows, gathered by each valid slot's index, its
   unpacked keys, exactly; `predict` on the 32 x 4096 edges through a
   table `DeviceTrainer` for `Net(96, mean / attn / lstm, bfloat16)`
   (lstm on K5), each with the fused route against the unfused one on
   one batch (bf16, 5e-2), the table scores against the keys path's
   with the same weights on N_REF queries (fp32, 1e-4) and the card
   against the CPU on N_REF queries (fp32, 1e-4); a cold fit (no
   synchronizing call) and a timed fit of the mean (8 epochs) and the
   attention Net (4 epochs) with card-vs-CPU training checks; a profile
   of a few table lstm predict batches; then the table lstm Net's
   training on K5 and K5 bwd: the route gradient checks, a cold and a
   timed 4-epoch fit, the card-vs-CPU training check; a profile of a
   few train steps of each table Net. Then the host engine on the table
   sets (`host_engine_path`): `LinkPredictor` one epoch of the mean Net
   (fp32) at batch 4096 over the 32 x 4096 edges, its q/s beside the
   device engine's epoch with the same Net and weights, and `evaluate`
   (MRR, 4096 sources x 100 negatives); it reads each step back by
   design, so no sync check.
   Then the keys join's impl "pallas" on K6: `predict` of the mean and
   lstm Nets (bf16) through `trainer_from_keys(..., join_factory=...)`
   on the 32 x 4096 edges, the joined feature pairs equal to the merge
   join's on one batch, the scores against the keys route's on it (fp32
   at 1e-4, bf16 at 5e-2), and one lstm predict in the general hi/lo
   layout, where the pallas and merge joins must be equal.
   Then the unfused keys routes (`Net(..., fused_hidden=False)`, whose
   join on the card carries the aligned keys and no feature pairs, so
   that K7 forms the hidden rows, and K7 bwd their gradient):
   `predict` of the mean, attn and lstm Nets (bf16) on the 32 x 4096
   edges; the K7 route against the feature-pair route on one batch
   (fp32 at 1e-4, bf16 at 5e-2); for each aggregator the K7 route's
   fp32 gradients against the fused route's (within 1e-3 of each
   tensor's largest), a cold fit (no synchronizing call) and a timed
   fit (mean 8 epochs, attn 4, lstm 1: the unfused lstm runs the plain
   scan, a Python loop over the slots), the card against the port's CPU
   path after 4 training steps, and a profile of a few train steps.
   Then the lstm Net on wide sets: 4 training steps at M=200, S'=4
   (L=801, the keys route, its stash whole) and 2 at batch 4096 in the
   general hi/lo layout (M=1000, S'=4, L=4001: K5 over the feature
   pairs, its 75.5 GB stash split into row groups), each with its peak
   device memory (below the card's) and the rows of a stash group.
   Then HONet, the hyperedge path (bench.py:274-307, `honet_path`), on
   the main path's sets: `HONet(96, dropout 0.1)` from prng_key(0)
   through `trainer_from_keys` over the hyperedge join
   (`make_keys_hjoin`, its feature pairs left out on the fused route),
   `predict` over 65,536 random hyperedges, the fused route (K1 as two
   Q=2 launches over the halves of the join's [B, 4L] cross plane)
   against the unfused one (the feature pairs) on one batch (fp32,
   1e-4), the card against the
   port's CPU path on 256 queries (1e-4), a cold 2-epoch fit (no
   synchronizing call) and a timed one over those hyperedges with random
   0/1 labels, the card against the CPU after 4 training steps, a
   profile of a few steps; K1, K1 bwd and K2 on HONet's own batch with
   its weights, K1 in both forms (one Q=4 launch over [B, 4L], two Q=2
   launches over its halves), at phase 2's tolerances, two launches bit
   for bit; and the two forms timed (kernels forward, backward and both
   as issued and queued, each form's forward and its forward and
   backward through autograd). Then the same at the tags-math
   class shape (M=200, S'=4, L=801, root planes) on the wide sets: a
   cold and a timed fit of 16 steps at batch 2048, the kernels and the
   two forms' times.
   Then the scalar encoders (`scalar_path`): the host push
   (`csrc/ppr_host.cpp`, the JAX CLI's alpha 0.5, eps 1e-4, topk 100,
   normalization 'sym') over every node (a probe of 16,384 seeds must
   predict under 60 s, else the first 65,536 rows), the PPR encoding and
   the padded sets (L <= 100) on the card; `Net(1, 96, bf16)` mean, attn
   and lstm through a scalar DeviceTrainer: predict on 32 x 4096 edges
   among the rows, the fused route against the unfused one on a batch
   (fp32 1e-4, bf16 5e-2), the card against the CPU on 256 queries, a
   cold fit (no synchronizing call) and a timed fit (8, 4, 4 epochs), the
   card against the CPU after 4 steps, profiles; K2 exactly on the scalar
   join's batch (the values' bits its payload), K5 and K5 bwd on the
   lstm's own hidden rows [8192, L, 96] at phase 2's tolerances. Then
   the device PPR (`ppr_device_check`): 4096 random seeds on the card,
   seeds/s beside the host push's, within the truncation bound of a
   float64 power iteration of 512 of them, and within the push's own
   bound (eps d_v) of the push on the shared support (the JAX test's
   5e-4 and 90% shared support printed beside). Then balanced batching
   on the main path's keys sets (`balanced_path`): classes at the 50th
   and 90th percentile of the queries' larger set size (rounded up to
   32) and 301, each class's share of queries and padded slots,
   `predict_balanced` against `predict` (1e-6, bit-equal or not) for
   mean and attn, a one-class `fit_balanced` at 301 against `fit` with
   the same permutations, a balanced and a plain mean fit timed in turns
   (3 each, medians), and one balanced attn epoch.
   Last, the link-prediction CLI (`cli_path`): `run_experiment` on four
   rows of scripts/run_jax_matrix.sh at its flags (fixture-collabs mean,
   attn and lstm, fixture-cites mean), then collabs mean with
   `--sencoder PPR`, collabs lstm with `--sencoder SPD`, collabs mean
   with `--balance_widths 32,64` and with `--engine host`, one run of 4
   epochs each (data
   prep, sampling, training, evaluation after epochs 0 and 2), each
   row's launches counted as its own path; every evaluated value must be
   finite and the best (valid, test) above CLI_FLOOR. After each row, its
   kernels on its own shapes (S'=2, L=101 or 41): the first training
   batch joined over the row's sets, with the weights its run left; K1
   and K1 bwd (mean rows), K3 and K3 bwd (attn) or K4 and K4 bwd (lstm),
   and K2, each against its plain version at phase 2's tolerances (the
   scalar rows K2 on the values' bits, and K5, K5 bwd for lstm; the host
   row K2 on its table join).
   Then the higher-order CLI (`cli_horder_path`):
   `main_horder.run_experiment` on the tags fixture at its row's flags
   (M=50, k=10, batch 4096, `--valid_perc 25`), one run of 4 epochs
   (evaluations after epochs 0, 2 and 3), its launches counted as
   `cli_tags_honet`, every MRR finite and the best pair above
   CLI_FLOOR, then its K1 (both forms), K1 bwd and K2 on its first
   training batch with the weights its run left; then the same row on
   the host engine (`cli_tags_honet_host`: `LinkPredictor` over
   `hgather_join`), K2 on its (u, w) merge.
   Between them, the checkpoints (`cli_resume_path`): the collabs mean
   row's run wrote `latest_0` before its epoch-2 evaluation; a
   `--resume latest_0` run trains epoch 3 (`cli_resume`), its parameters
   within rtol 1e-4 / atol 1e-5 of the straight run's (bitwise or not
   printed); `--inf_only --load_model latest_0` (`cli_inf_only`) equals
   the straight run's epoch-2 evaluation exactly; the tags row with an
   evaluation an epoch and `--early_stop 1` (`cli_tags_honet_stop`)
   writes its checkpoint at the first evaluation that does not improve,
   and `--inf_only` over it (`cli_horder_inf_only`) equals that
   evaluation exactly. Then relation prediction (`cli_mag_path`):
   MAG(P-P) at paper Table 8's settings (M=100, num_steps 4: L=301,
   mean, hidden 96, k=10, batch 4096, 4 epochs, evaluations after epochs
   0 and 2) over a synthetic MAG of 100,000 authors and 150,000 papers
   (1,000,000 writes, 2,000,000 cites; valid and test cut to their first
   4,096 sources of 1,000 negatives each) written as `mag_cite.npz`,
   every MRR finite and in [0, 1], the seconds of each part and the peak
   memory printed, then K1, K1 bwd and K2 on its first training batch
   with its trained weights. Last, the legacy walk API (`legacy_path`)
   over 65,536 seeds of the bench graph: `walk_sampler` (M=100, S'=3),
   `rw_matrix` (M=200, num_steps 4), `batch_sampler` and `walk_join`,
   their invariants held and `walk_join` on the card equal to its CPU
   result exactly. Then the multi-device path (`multi_device_path`,
   `surel_plus_tpu_torch/parallel/`): four ranks started by
   `parallel.launch.run_ranks`, sharing the one card over gloo (mesh data
   2 x graph 2; they share its SMs and exchange through host memory, so
   the rates measure no scaling). Each rank (`multi_device_rank`) builds
   the main path's graph, partitions it four ways (`partition_csr`),
   samples every node's set through the frontier exchange
   (`sample_gsets_partitioned`, the probe over the edge tables; sets/s)
   and holds its rows to `sample_block` over the whole seed block from
   the same key, exactly; the capacity routing and the grouped
   sampler (group 2) to the probe's rows; moves the rows to their graph
   shards (`shard_spg_keys`) and holds them to the store's; times the
   psum and the all-to-all row gathers on a batch's ids (equal exactly);
   runs `DistributedKeysTrainStep` with `Net(96, mean, bf16)` at batch
   4096 (2048 a data rank): a cold step, then 16 timed (ms a step, q/s
   for each rank); the fp32 mean step held to rank 0's single-process
   `DeviceTrainer` step on the same batch (loss rtol 1e-5, gradients and
   parameters rtol 1e-4 / atol 1e-5, a parameter whose gradient is
   rounding noise within 2 lr), the attn and lstm steps (loss within
   1e-4); HONet(96, fp32)'s step over 4096 hyperedges held the same way
   and its scorer's scores within 1e-4 of `predict`; the fp32 mean
   Net's `DistributedKeysScorer` within 1e-4 of `predict` on 4096 x 101
   pairs, then `evaluate_distributed`'s MRR over 4096 sources x 1001
   candidates (pairs/s). The ranks' launch counts are summed into the
   `multi_device*` paths. Then `dryrun_multichip` at world 1 over NCCL,
   and over NCCL across min(4, cards) cards where the machine has more
   than one. Last, the large-graph path (`scale_path`):
   `cli/scale_demo.py`'s device stages at a cut graph (R-MAT pairs of
   2,000,000 nodes and 24,000,000 draws, the native ingest, the upload,
   shuffle and int32 edge tables timed apart, cold and warm sampling of
   262,144 sets at M=50, S'=3, bucket 128, a cold and a timed 4-epoch fit
   of `Net(96, mean, bf16)` over 65,536 queries), each stage's seconds
   and peak device memory; the walk graph must take 32 B a directed edge
   plus indptr, and the card's sets must equal the CPU port's on the
   first 4,096 seeds.
4. Requires every kernel of each path to have launched while that path
   ran (the counts are set to 0 just before the path and read just
   after), prints one JSON line describing each kernel, the run's total
   seconds, the card's name and power limit, and, last, the result
   line.

Exits non-zero, printing no result line, when there is no CUDA device or
any phase fails.

"""

from __future__ import annotations

import collections
import dataclasses
import functools
import gc
import glob
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

# The allocator maps memory into growing segments instead of caching fixed
# ones: after every earlier phase, the general layout's lstm fit (69 GiB
# at its peak) found 16.8 GiB cached but in pieces, none big enough for a
# 14.8 GiB stash group. Set before torch starts; a caller's setting wins.
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np
import torch

from surel_plus_tpu_torch.cli import main_horder, scale_demo
from surel_plus_tpu_torch.cli.main import run_experiment
from surel_plus_tpu_torch.graph import rmat_graph
from surel_plus_tpu_torch.graph.datasets import synthetic_hetero_data
from surel_plus_tpu_torch.models import HONet, Net
from surel_plus_tpu_torch.models.honet import group_set_sums
from surel_plus_tpu_torch.models.layers import LSTMAggregation
from surel_plus_tpu_torch.ops import join as join_ops
from surel_plus_tpu_torch.ops import legacy
from surel_plus_tpu_torch.ops import ppr as ppr_ops
from surel_plus_tpu_torch.ops import prng
from surel_plus_tpu_torch.ops import walk as walk_ops
from surel_plus_tpu_torch.ops.encoders import (
    encoding,
    gather_join_scalar,
    scalar_spg_from_csr,
)
from surel_plus_tpu_torch.ops.join import (
    gather_join,
    join_gathered_hkeys,
    join_gathered_keys,
    make_keys_hjoin,
    make_keys_join,
    unpack_key_features,
)
from surel_plus_tpu_torch.ops.kernels import (
    attn_pool,
    build,
    hidden_sum,
    lstm_keys,
    merge,
    threefry,
)
from surel_plus_tpu_torch.ops.kernels import cross_lookup as xlookup
from surel_plus_tpu_torch.ops.kernels import lstm as lstm_x
from surel_plus_tpu_torch.ops.kernels.hidden_sum import NEG, u_core_rows
from surel_plus_tpu_torch.ops.ppr_device import ppr_topk_device
from surel_plus_tpu_torch.ops.sampler import (
    dedup_device,
    device_graph,
    sample_gsets_device,
    sample_gsets_device_keys,
    shuffled_indices_for,
    walk_tables_for,
)
from surel_plus_tpu_torch.spg import SpGDevice, SpGKeys
from surel_plus_tpu_torch.train import LinkPredictor, TrainConfig, evaluate
from surel_plus_tpu_torch.train.device import (
    DeviceTrainer,
    batch_loss,
    device_mrr,
    riffle_permutation,
    trainer_from_keys,
)
from surel_plus_tpu_torch.utils.checkpoint import load_checkpoint
from surel_plus_tpu_torch.utils.config import (
    ExperimentConfig,
    apply_dataset_overrides,
)
from surel_plus_tpu_torch.utils.profiling import metrics

DEVICE = "cuda"
N_NODES, N_EDGES = 250_000, 2_500_000           # bench.py:114-115
NUM_WALKS, NUM_STEPS = 100, 3                   # bench.py:116
WIDE_WALKS, WIDE_STEPS = 200, 4                 # lead-in-hi layout
GEN_WALKS, GEN_STEPS, GEN_SEEDS = 1000, 4, 4096  # general hi/lo layout
HIDDEN, BATCH, N_BATCHES = 96, 4096, 32         # bench.py:117-118, 154
SAMPLE_BLOCK = 65536                            # bench.py:126
N_SRC, K_NEG = 4096, 1000                       # bench.py:241
N_REF = 256                                     # queries held to the CPU
K1_RTOL, K1_ATOL = 1e-4, 1e-3
K1B_TOL = 1e-4          # of each dU row's largest magnitude
ROUTE_TOL = 5e-2
GRAD_ROUTE_TOL = {"float32": 1e-3, "bfloat16": ROUTE_TOL}   # of tensor max
CPU_TOL = 1e-4
# `held_route_grads`: the most queries of a batch of BATCH whose scorer
# relu decisions two routes may part, and the band of 0, as a share of
# the largest pre-activation, in which a parted decision counts as
# rounding's (the routes' logits limits)
PARTED_QUERIES = {"float32": 4, "bfloat16": BATCH // 2}
PARTED_BAND = {"float32": CPU_TOL, "bfloat16": ROUTE_TOL}
CPU_TRAIN_RTOL, CPU_TRAIN_ATOL = 1e-4, 1e-5
TIMED_ITERS = 20
# the device wait before timed launches: at most this long, in cycles of a
# clock of at most 2 GHz (the H100's SM clock peaks at 1.98 GHz)
QUEUE_AHEAD_MAX_S, SLEEP_CYCLES_PER_S = 0.05, 2e9
N_EPOCHS, LR, GRAD_CLIP = 8, 1e-3, 1.0          # bench.py:153, 167
ATTN_EPOCHS = 4                                 # bench.py:206
REF_STEPS, REF_BATCH = 4, 64                    # card vs CPU training
ATTN_RTOL, ATTN_ATOL = 1e-4, 1e-4     # pooled rows, m and s, fp32
ATTN_BWD_TOL = 1e-4     # of each dU row's largest magnitude
ATTN_CANCEL_TOL = 1e-6  # of the summed terms' sizes (attn_bwd_scales)
GATE_BIAS = "aggr.gate_nn.bias"
GATE_BIAS_GRAD_ATOL = 1e-5                      # its gradient is noise
# after n Adam steps on a noise gradient it may differ by up to ~lr a step
GATE_BIAS_FIT_ATOL = 2 * LR * REF_STEPS
LSTM_TOL = 1e-4         # K4 and cuDNN vs plain, fp32 over up to 801 steps
LSTM_BWD_TOL = 1e-4     # K4 bwd vs plain, of each gradient's largest entry
LSTM_EPOCHS = 4                                 # bench.py:206
# the unfused lstm route runs the plain scan, a Python loop over the slots
UNFUSED_LSTM_EPOCHS = 1
K7_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}  # one bf16 ulp
K7_ATOL = 1e-5
K7B_TOL = 1e-4          # of each dU row's largest magnitude
# the CLI's rows: scripts/run_jax_matrix.sh's flags, one run each, the
# epochs cut to CLI_EPOCHS (evaluations after epochs 0 and 2)
CLI_EPOCHS = 4
CLI_ROWS = {
    "collabs_mean": dict(dataset="fixture-collabs", aggrs="mean",
                         num_walks=50, k=10, batch_size=4096),
    "collabs_attn": dict(dataset="fixture-collabs", aggrs="attn",
                         num_walks=50, k=10, batch_size=4096),
    "collabs_lstm": dict(dataset="fixture-collabs", aggrs="lstm",
                         num_walks=20, k=5, batch_size=1024),
    "cites_mean": dict(dataset="fixture-cites", aggrs="mean", num_walks=50,
                       k=10, batch_size=4096),
    # the scalar encoders, balanced batching and the host engine on the
    # collabs rows' flags
    "collabs_mean_ppr": dict(dataset="fixture-collabs", aggrs="mean",
                             num_walks=50, k=10, batch_size=4096,
                             sencoder="PPR"),
    "collabs_lstm_spd": dict(dataset="fixture-collabs", aggrs="lstm",
                             num_walks=20, k=5, batch_size=1024,
                             sencoder="SPD"),
    "collabs_mean_balanced": dict(dataset="fixture-collabs", aggrs="mean",
                                  num_walks=50, k=10, batch_size=4096,
                                  balance_widths="32,64"),
    "collabs_mean_host": dict(dataset="fixture-collabs", aggrs="mean",
                              num_walks=50, k=10, batch_size=4096,
                              engine="host"),
}
# the least best (valid, test) a row must reach; random scores give about
# 50 / 100,000 Hits@50 on the collabs fixture and H(51) / 51 = 0.088 MRR
# against the cites fixture's 50 negatives a source
CLI_FLOOR = {"Hits@50": 0.01, "MRR": 0.2}
# HONet: bench.py:274-307 (2 epochs over 65,536 random hyperedges, batch
# 4096, on the main path's sets), then the tags-math class shape (M=200,
# S'=4, L=801: the lead-in-hi layout) at batch 2048 for TAGS_STEPS steps
H_EPOCHS, H_EDGES = 2, N_BATCHES * BATCH // 2
TAGS_BATCH, TAGS_STEPS = 2048, 16
# the tags fixture's HONet row (FIXTURE_RESULTS.md:72), one run of
# CLI_EPOCHS epochs: evaluations after epochs 0, 2 and 3 (the JAX CLI's
# blocks); random scores give H(51) / 51 = 0.088 MRR against its 50
# negatives a triplet
TAGS_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "surel_plus_tpu", "data", "fixtures",
                            "tags_fixture.npz")
CLI_HROW = dict(dataset=f"npz:{TAGS_FIXTURE}", num_walks=50, k=10,
                batch_size=4096, valid_perc=25)
# the row on each engine
CLI_HROWS = {"tags_honet": {}, "tags_honet_host": dict(engine="host")}
# the checkpoint checks: the straight run is CLI_ROWS' RESUME_ROW, which
# writes latest_0 at its epoch-2 evaluation; the resumed run holds its
# parameters at the card-vs-CPU tolerance (PERF.md §2). The higher-order
# CLI's best checkpoint: the tags row, an evaluation an epoch, stopped at
# the first evaluation that does not improve (at most HSTOP_EPOCHS)
RESUME_ROW = "collabs_mean"
RESUME_RTOL, RESUME_ATOL = 1e-4, 1e-5
HSTOP_EPOCHS = 20
# MAG(P-P), relation prediction: the paper's Table 8 settings (SURVEY.md:
# 405: S=4, M=100; hidden 96, k=10, batch 4096) on a synthetic MAG of the
# main path's graph size (250,000 nodes), valid and test cut to their
# first MAG_QUERIES sources of MAG_NEG negatives each, so that an
# evaluation scores 4096 x 1001 pairs a split as bench.py's MRR does
MAG_DATA = dict(num_authors=100_000, num_papers=150_000,
                num_writes=1_000_000, num_cites=2_000_000, relation="cite",
                neg_per_query=1000)
MAG_QUERIES = 4096
CLI_MAG = dict(relation="cite", num_walks=100, num_steps=4, aggrs="mean",
               hidden_channels=96, k=10, batch_size=4096)
# the large-graph path (`cli/scale_demo.py`'s device stages) at a cut
# graph: R-MAT pairs of 2,000,000 nodes, 24,000,000 draws (about 48M
# directed edges), a set for each of the first 262,144 nodes at M=50,
# S'=3, bucket 128, Net(96, mean, bf16) 4 epochs over 65,536 queries; the
# card's warm sets held to the CPU's for the first SCALE_CPU_SEEDS seeds
SCALE = dict(n=2_000_000, draws=24_000_000, seeds=262_144, queries=65_536,
             walks=50, steps=3, bucket=128)
SCALE_CPU_SEEDS = 4096
# the legacy walk API over the bench graph: walk_sampler at M=100, S'=3,
# rw_matrix at M=200, num_steps 4 (walks of 3 steps), batch_sampler and
# walk_join, each over LEGACY_SEEDS seeds
LEGACY_SEEDS = 65_536
# the scalar path: the JAX CLI's PPR defaults (utils/config.py:31-33); the
# host push runs over every node unless a probe predicts more than the
# budget, and then over the first SCALAR_ROWS_CUT rows
SCALAR_ALPHA, SCALAR_EPS, SCALAR_TOPK = 0.5, 1e-4, 100
PUSH_PROBE, PUSH_BUDGET_S, SCALAR_ROWS_CUT = 16_384, 60.0, 65_536
# the device PPR check: random seeds, seeds a product, the float64
# reference's steps ((1 - alpha)^40 < 1e-12), the JAX test's bound
PPR_SEEDS, PPR_BLOCK, EXACT_ITERS, PPR_TOL = 4096, 512, 40, 5e-4
# balanced batching: predict_balanced against predict, the timed turns
BAL_PREDICT_TOL, BAL_TURNS, BAL_EPOCHS = 1e-6, 3, 2
# the host engine's evaluation: negatives a source
HOST_NEG = 100
# operations of one LSTM cell update per unit: three sigmoids (exp, add,
# divide) and two tanh (counted as 3 each), the cell's 3 and the output's 1
LSTM_CELL_OPS = 19
# and of its backward per unit: c and tanh(c) again (5), dc~ (5), the four
# dgates (4 each), dc_prev (1), the four dbh sums (4)
LSTM_CELL_BWD_OPS = 31

# NVIDIA's H100 SXM data sheet: HBM3 rate, fp32 peak of the CUDA cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12      # CUDA cores, outside the tensor cores
TF32_OPS_PER_S = 495e12     # tensor cores, TF32, dense
# the data sheet gives no integer rate: an H100 SM issues at most four
# warp instructions a clock, 128 lanes, the lanes behind FP32_OPS_PER_S
# (which counts an FMA as two operations), whatever pipe runs them
INT32_OPS_PER_S = FP32_OPS_PER_S / 2
# K8 (threefry2x32-20): its known answers, as constants (no JAX on the
# card): Random123's test vector (key (0, 0), counter (0, 0)), and JAX
# 0.9's jax.random on the CPU: bits(PRNGKey(0), [8], uint32),
# split(PRNGKey(0), 2) and fold_in(PRNGKey(111413), 7)
THREEFRY_KAT = (0x6B200159, 0x99BA4EFE)
JAX_BITS_KEY0 = (4070199207, 4202968722, 1427181096, 2012915765,
                 2447653815, 710830403, 1332275837, 2961296638)
JAX_SPLIT_KEY0 = [(1797259609, 2579123966), (928981903, 3453687069)]
JAX_FOLD_111413_7 = (559376686, 1310254177)
# the sizes K8 is held to its plain version at (the last: a sampler
# block's step draw), and a start counter just below 2^32
K8_SIZES = (1, 1023, 4097, SAMPLE_BLOCK * NUM_WALKS)
K8_HIGH_OFFSET = (1 << 32) - 3
# 32-bit integer operations a word: 20 rounds of an add, a rotate and a
# xor, 12 key additions, the counter's split and the final xor
THREEFRY_OPS = 20 * 3 + 12 + 2 + 1
# the hidden-layer kernels and the merge, which each profile lists wherever
# they rank
LISTED_KERNELS = re.compile(
    r"hidden_(sum|slots)_(fwd|bwd)|reduce_partials|merge_pairs")

KERNELS = {
    "hidden_sum_fwd": dict(
        kernel=hidden_sum.KERNEL,
        source="surel_plus_tpu_torch/csrc/hidden_sum.cu",
        replaces="surel_plus_tpu/ops/pallas/hidden_sum_kernel.py:169"),
    "hidden_sum_bwd": dict(
        kernel=hidden_sum.BWD_KERNEL,
        source="surel_plus_tpu_torch/csrc/hidden_sum_bwd.cu",
        replaces="surel_plus_tpu/ops/pallas/hidden_sum_kernel.py:199"),
    "merge_pairs": dict(
        kernel=merge.KERNEL, source="surel_plus_tpu_torch/csrc/merge.cu",
        replaces="surel_plus_tpu/ops/pallas/bitonic_merge.py:44"),
    "attn_pool_fwd": dict(
        kernel=attn_pool.ATTN_KERNEL,
        source="surel_plus_tpu_torch/csrc/attn_pool.cu",
        replaces="surel_plus_tpu/ops/pallas/hidden_sum_kernel.py:579"),
    "attn_pool_bwd": dict(
        kernel=attn_pool.ATTN_BWD_KERNEL,
        source="surel_plus_tpu_torch/csrc/attn_pool_bwd.cu",
        replaces="surel_plus_tpu/ops/pallas/hidden_sum_kernel.py:598"),
    "lstm_keys_fwd": dict(
        kernel=lstm_keys.LSTM_KERNEL,
        source="surel_plus_tpu_torch/csrc/lstm_keys.cu",
        replaces="surel_plus_tpu/ops/pallas/lstm_kernel.py:882"),
    "lstm_keys_bwd": dict(
        kernel=lstm_keys.LSTM_BWD_KERNEL,
        source="surel_plus_tpu_torch/csrc/lstm_keys_bwd.cu",
        replaces="surel_plus_tpu/ops/pallas/lstm_kernel.py:934"),
    "lstm_x_fwd": dict(
        kernel=lstm_x.LSTM_X_KERNEL,
        source="surel_plus_tpu_torch/csrc/lstm.cu",
        replaces="surel_plus_tpu/ops/pallas/lstm_kernel.py:87"),
    "lstm_x_bwd": dict(
        kernel=lstm_x.LSTM_X_BWD_KERNEL,
        source="surel_plus_tpu_torch/csrc/lstm_bwd.cu",
        replaces="surel_plus_tpu/ops/pallas/lstm_kernel.py:120"),
    "cross_lookup": dict(
        kernel=xlookup.KERNEL,
        source="surel_plus_tpu_torch/csrc/cross_lookup.cu",
        replaces="surel_plus_tpu/ops/pallas/join_kernel.py:33"),
    "hidden_slots_fwd": dict(
        kernel=hidden_sum.SLOTS_KERNEL,
        source="surel_plus_tpu_torch/csrc/hidden_slots.cu",
        replaces="surel_plus_tpu/ops/pallas/hidden_sum_kernel.py:382"),
    "hidden_slots_bwd": dict(
        kernel=hidden_sum.SLOTS_BWD_KERNEL,
        source="surel_plus_tpu_torch/csrc/hidden_slots_bwd.cu",
        replaces="surel_plus_tpu/ops/pallas/hidden_sum_kernel.py:402"),
    # no Pallas kernel: the walk's jax.random.bits, which XLA computes
    "threefry_bits": dict(
        kernel=threefry.KERNEL,
        source="surel_plus_tpu_torch/csrc/threefry.cu",
        replaces="surel_plus_tpu/ops/walk.py:183"),
}
# the kernels each main path must launch
PATHS = {"init_from_key": ("threefry_bits",),
         "serve": ("hidden_sum_fwd", "merge_pairs", "threefry_bits"),
         "train": ("hidden_sum_fwd", "hidden_sum_bwd", "merge_pairs",
                   "threefry_bits"),
         "attn_serve": ("attn_pool_fwd", "merge_pairs"),
         "attn_train": ("attn_pool_fwd", "attn_pool_bwd", "merge_pairs"),
         "lstm_serve": ("lstm_keys_fwd", "merge_pairs"),
         "lstm_train": ("lstm_keys_fwd", "lstm_keys_bwd", "merge_pairs"),
         "table_serve": ("merge_pairs",),
         "table_lstm_serve": ("lstm_x_fwd", "merge_pairs"),
         "table_train": ("merge_pairs",),
         "table_attn_train": ("merge_pairs",),
         "table_lstm_train": ("lstm_x_fwd", "lstm_x_bwd", "merge_pairs"),
         "keys_pallas_serve": ("cross_lookup", "lstm_x_fwd"),
         "unfused_serve": ("hidden_slots_fwd", "merge_pairs"),
         "unfused_train": ("hidden_slots_fwd", "hidden_slots_bwd",
                           "merge_pairs"),
         "unfused_attn_train": ("hidden_slots_fwd", "hidden_slots_bwd",
                                "merge_pairs"),
         "unfused_lstm_train": ("hidden_slots_fwd", "hidden_slots_bwd",
                                "merge_pairs"),
         "cli_collabs_mean": ("hidden_sum_fwd", "hidden_sum_bwd",
                              "merge_pairs"),
         "cli_collabs_attn": ("attn_pool_fwd", "attn_pool_bwd",
                              "merge_pairs"),
         "cli_collabs_lstm": ("lstm_keys_fwd", "lstm_keys_bwd",
                              "merge_pairs"),
         "cli_cites_mean": ("hidden_sum_fwd", "hidden_sum_bwd",
                            "merge_pairs"),
         "honet_serve": ("hidden_sum_fwd", "merge_pairs"),
         "honet_train": ("hidden_sum_fwd", "hidden_sum_bwd", "merge_pairs"),
         "honet_tags_train": ("hidden_sum_fwd", "hidden_sum_bwd",
                              "merge_pairs"),
         "cli_tags_honet": ("hidden_sum_fwd", "hidden_sum_bwd",
                            "merge_pairs"),
         "scalar_serve": ("merge_pairs",),
         "scalar_lstm_serve": ("lstm_x_fwd", "merge_pairs"),
         "scalar_train": ("merge_pairs",),
         "scalar_attn_train": ("merge_pairs",),
         "scalar_lstm_train": ("lstm_x_fwd", "lstm_x_bwd", "merge_pairs"),
         "balanced_serve": ("hidden_sum_fwd", "merge_pairs"),
         "balanced_train": ("hidden_sum_fwd", "hidden_sum_bwd",
                            "merge_pairs"),
         "balanced_attn_train": ("attn_pool_fwd", "attn_pool_bwd",
                                 "merge_pairs"),
         "host_engine": ("merge_pairs",),
         "cli_collabs_mean_ppr": ("merge_pairs",),
         "cli_collabs_lstm_spd": ("lstm_x_fwd", "lstm_x_bwd",
                                  "merge_pairs"),
         "cli_collabs_mean_balanced": ("hidden_sum_fwd", "hidden_sum_bwd",
                                       "merge_pairs"),
         "cli_collabs_mean_host": ("merge_pairs",),
         "cli_tags_honet_host": ("merge_pairs",),
         "cli_mag": ("hidden_sum_fwd", "hidden_sum_bwd", "merge_pairs"),
         "cli_resume": ("hidden_sum_fwd", "hidden_sum_bwd", "merge_pairs"),
         "cli_inf_only": ("hidden_sum_fwd", "merge_pairs"),
         "cli_tags_honet_stop": ("hidden_sum_fwd", "hidden_sum_bwd",
                                 "merge_pairs"),
         "cli_horder_inf_only": ("hidden_sum_fwd", "merge_pairs"),
         "multi_device": ("hidden_sum_fwd", "hidden_sum_bwd", "merge_pairs"),
         "multi_device_attn": ("attn_pool_fwd", "attn_pool_bwd",
                               "merge_pairs"),
         "multi_device_lstm": ("lstm_keys_fwd", "lstm_keys_bwd",
                               "merge_pairs"),
         "multi_device_honet": ("hidden_sum_fwd", "hidden_sum_bwd",
                                "merge_pairs"),
         "multi_device_serve": ("hidden_sum_fwd", "merge_pairs"),
         "scale": ("hidden_sum_fwd", "hidden_sum_bwd", "merge_pairs",
                   "threefry_bits")}
# the path whose count the kernels line reports
MAIN_PATH = {"hidden_sum_fwd": "train", "hidden_sum_bwd": "train",
             "merge_pairs": "train", "attn_pool_fwd": "attn_train",
             "attn_pool_bwd": "attn_train", "lstm_keys_fwd": "lstm_train",
             "lstm_keys_bwd": "lstm_train", "lstm_x_fwd": "table_lstm_serve",
             "lstm_x_bwd": "table_lstm_train",
             "cross_lookup": "keys_pallas_serve",
             "hidden_slots_fwd": "unfused_train",
             "hidden_slots_bwd": "unfused_train",
             "threefry_bits": "serve"}



class SmokeFailure(RuntimeError):
    pass


def require(ok, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def say(*parts) -> None:
    print(*parts, flush=True)


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def sync() -> None:
    torch.cuda.synchronize()


def queue_ahead(fn, iters: int) -> None:
    """Hold the device in a wait long enough for the host to queue `iters`
    calls of `fn` (its host time, from one call, 1.5 times over; at most
    QUEUE_AHEAD_MAX_S), so that no launch's timed window holds an idle gap
    while the host is still issuing it: `launch_spread` shows how much of a
    short kernel's time as issued (`time_ms`) is the host's (PERF.md)."""
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    sync()
    wait_s = min(QUEUE_AHEAD_MAX_S, 1.5 * iters * host_s + 1e-3)
    torch.cuda._sleep(int(wait_s * SLEEP_CYCLES_PER_S))


def launch_times(fn, iters, flush=None, queued=True):
    """Device times in ms of `iters` launches of `fn`, each after `flush`
    (None: back to back, one time over all of them, divided), queued
    behind a device wait (`queue_ahead`) unless `queued` is False."""
    fn()
    sync()
    if queued:
        queue_ahead(fn, iters)
    if flush is None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        sync()
        return [start.elapsed_time(end) / iters]
    events = []
    for _ in range(iters):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    sync()
    return [s.elapsed_time(e) for s, e in events]


def time_ms(fn, iters: int = TIMED_ITERS) -> float:
    """Median device time of `fn` in ms, L2 flushed before each run, the
    runs timed as the host issues them."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=DEVICE)
    return float(np.median(launch_times(fn, iters, flush.zero_,
                                        queued=False)))


def queued_ms(fn, iters: int = TIMED_ITERS) -> float:
    """Median device time of `fn` in ms, L2 flushed before each run by
    zeroing, the runs queued behind a device wait (`queue_ahead`): the
    time without the host's launch gap."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=DEVICE)
    return float(np.median(launch_times(fn, iters, flush.zero_)))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(bytes_moved: float, ops: float):
    """(bound_ms, bound_by): the larger of the memory and the op time."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------- phase 2
def joined_batch(g, num_walks, num_steps, seed):
    """Sets for BATCH random query edges of `g`, sampled on the card, and
    their join: the merged-order planes (the fused mean route's inputs)
    and the slot-aligned keys (the fused attention route's)."""
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, g.num_nodes, size=2 * BATCH)
    spgk = sample_gsets_device_keys(g, seeds, num_walks, num_steps,
                                    seed=seed, block_size=SAMPLE_BLOCK,
                                    device=DEVICE)
    rows = torch.arange(2 * BATCH, device=DEVICE).reshape(2, BATCH)
    joined = join_gathered_keys(spgk.nodes[rows], spgk.khi[rows],
                                spgk.klo[rows], spgk.sizes[rows],
                                num_walks, num_steps, features=False)
    return spgk, rows, joined


def k1_inputs(joined, num_walks, num_steps, gen):
    w1 = torch.randn(num_steps + 1, HIDDEN, generator=gen) * 0.5
    b1 = torch.randn(HIDDEN, generator=gen) * 0.1
    u_ext = torch.cat([u_core_rows(w1, num_walks, num_steps),
                       torch.full((1, HIDDEN), NEG), b1[None]]).to(DEVICE)
    return (joined.kown, joined.mask, joined.kcross, joined.kcross_mask,
            u_ext.contiguous(), int(num_walks).bit_length(),
            joined.kown_root, joined.kcross_root)


def k1_work(args):
    """K1's work on these inputs: (bytes, CUDA-core operations, tensor-core
    operations, the first version's fp32 operations). A slot any endpoint
    selects is computed once: its z on the tensor cores (8 multiply-adds a
    channel, K padded to 8, in each product: one while 2 ncol <= 8, one
    more past shift 11, two while 2 ncol > 8), a max a channel on the CUDA
    cores, then one add a channel for each endpoint that selects it. The
    first version formed z with ncol fmaf on the CUDA cores."""
    kown, mown, kcross, mcross, u_ext, shift, rown, rcross = args
    q, b, _ = kown.shape
    ncol, h = u_ext.shape[0] - 2, u_ext.shape[1]
    moved = nbytes(kown, mown, kcross, mcross, u_ext, rown, rcross) \
        + q * b * h * 4
    computed = int(mown.sum()) + int(mcross.any(dim=0).sum())
    selected = int(mown.sum()) + int(mcross.sum())
    products = (1 + (shift > 11)) if 2 * ncol <= 8 else 2
    return (moved, (computed + selected) * h,
            computed * h * 2 * 8 * products,
            computed * h * (2 * ncol + 1) + selected * h)


def k1_bound(args):
    """(bound_ms, bound_by): the larger of K1's bytes at the memory rate,
    its CUDA-core operations at the fp32 rate and its products at the TF32
    tensor rate."""
    moved, cuda_ops, tc_ops, _ = k1_work(args)
    t = {"bytes": moved / HBM_BYTES_PER_S,
         "operations": max(cuda_ops / FP32_OPS_PER_S,
                           tc_ops / TF32_OPS_PER_S)}
    by = max(t, key=t.get)
    return t[by] * 1e3, by


def k1_bound_parts(args):
    """K1's bound's three terms and the first version's fp32 bound, in ms."""
    moved, cuda_ops, tc_ops, fp32_ops = k1_work(args)
    return dict(bytes_ms=moved / HBM_BYTES_PER_S * 1e3,
                cuda_ms=cuda_ops / FP32_OPS_PER_S * 1e3,
                k1_tc_ms=tc_ops / TF32_OPS_PER_S * 1e3,
                fp32_bound_ms=bound(moved, fp32_ops)[0])


def k1_compare(args, label, empty_set=False):
    """K1 against its plain version at K1_RTOL / K1_ATOL, two launches bit
    for bit, and with `empty_set` set 0 (all masked) exactly 0."""
    got = hidden_sum.fused_key_hidden_sum_cuda(*args)
    again = hidden_sum.fused_key_hidden_sum_cuda(*args)
    want = hidden_sum.fused_key_hidden_sum_plain(*args)
    sync()
    require(got.shape == want.shape and bool(torch.isfinite(got).all()),
            f"K1 {label}: bad output")
    same = torch.equal(got.view(torch.int32), again.view(torch.int32))
    empty = not empty_set or bool((got[:, 0] == 0).all())
    err = float((got - want).abs().max())
    ok = torch.allclose(got, want, rtol=K1_RTOL, atol=K1_ATOL)
    say(f"K1 {label}: Q,B,L,Lc={tuple(args[0].shape)},{args[2].shape[1]} "
        f"valid own slots {float(args[1].float().mean()):.3f}, selected "
        f"cross slots {float(args[3].any(dim=0).float().mean()):.3f}; "
        f"max_abs_err={err:.3e} max|plain|={float(want.abs().max()):.3e} "
        f"(rtol {K1_RTOL}, atol {K1_ATOL}); repeat bit-identical: {same}"
        + (f"; all-masked set exactly 0: {empty}" if empty_set else "")
        + f" {'ok' if ok and same and empty else 'FAIL'}")
    require(ok, f"K1 {label} disagrees with its plain version")
    require(same, f"K1 {label}: two launches differ")
    require(empty, f"K1 {label}: the all-masked set is not 0")
    return err


def near_zero_u(u_ext, gen):
    """u_ext whose z is exactly 0 wherever a key's fields 0 and 1 agree (U_1
    = -U_0, the other field rows 0, b1 = 0) in half the channels, and a few
    ulps of U_0 off 0 there in the other half (b1 = k 2^-23 U_0, |k| <=
    4): K1's tensor-core z lies within its recheck bound of 0 at many
    slots."""
    u = u_ext.clone()
    ncol, h = u.shape[0] - 2, u.shape[1]
    half = h // 2
    u[1] = -u[0]
    u[2:ncol] = 0.0
    u[ncol + 1, :half] = 0.0
    k = torch.randint(-4, 5, (h - half,), generator=gen).to(DEVICE)
    u[ncol + 1, half:] = u[0, half:] * k.float() * 2.0 ** -23
    return u.contiguous()


def k1_near_zero(args, gen):
    """K1 on `near_zero_u`'s weights, held like every K1 case; prints the
    share of the selected own slot-channels whose plain z is exactly 0."""
    kown, mown, kcross, mcross, u_ext, shift, rown, rcross = args
    u = near_zero_u(u_ext, gen)
    ncol = u.shape[0] - 2
    z = hidden_sum._fields_ext(kown, ~mown, shift, ncol, rown) @ u
    zero = float(((z == 0) & mown[..., None]).sum()) / max(
        1.0, float(mown.sum()) * u.shape[1])
    del z
    say(f"K1 near zero: {zero:.4f} of the selected own slot-channels have "
        f"z exactly 0 (plain)")
    return k1_compare((kown, mown, kcross, mcross, u, shift, rown, rcross),
                      "near zero, lo-only")


def k1_near_bound(f, u_ext):
    """K1's recheck bound [..., H] for the fields f [..., ncol]: S /
    2^TC_NEAR_SHIFT, S = max |b1| + sum_i f_i max |U_i| with the maxima
    over the channels of the slot's slab, 0 where the fields meet no
    nonzero U row."""
    ncol, h = u_ext.shape[0] - 2, u_ext.shape[1]
    cs = 16 * hidden_sum.slab_mtiles(ncol, False)
    out = torch.empty(*f.shape[:-1], h, device=f.device)
    for c0 in range(0, h, cs):
        u = u_ext[:, c0:c0 + cs].abs()
        t = f @ u[:ncol].amax(dim=1)
        s = torch.where(t > 0, u[ncol + 1].max() + t, 0.0)
        out[..., c0:c0 + cs] = (s * 2.0 ** -hidden_sum.TC_NEAR_SHIFT)[
            ..., None]
    return out


def k1_near_share(args, label):
    """The share of K1's computed slot-channels whose z (the plain
    version's) lies within K1's recheck bound of 0 (`k1_near_bound`)."""
    kown, mown, kcross, mcross, u_ext, shift, rown, rcross = args
    ncol, h = u_ext.shape[0] - 2, u_ext.shape[1]
    near = total = 0
    for keys, sel, root in ((kown, mown, rown),
                            (kcross, mcross.any(dim=0), rcross)):
        fe = hidden_sum._fields_ext(keys, ~sel, shift, ncol, root)
        z = fe @ u_ext
        near += int(((z.abs() < k1_near_bound(fe[..., :ncol], u_ext))
                     & sel[..., None]).sum())
        total += int(sel.sum()) * h
        del z, fe
    say(f"K1 recheck {label}: {near} of {total} computed slot-channels "
        f"({near / max(total, 1):.3e}) have |z| within the bound")


def k1_decisions(args, gen, label, draws=4):
    """K1's relu decisions against the fmaf order on `near_zero_u`'s
    weights: in each of `draws` launches every set holds one selected slot
    (a valid own slot, or a valid cross slot of one or both endpoints), so
    that out = relu(z) of that slot, and (out > 0) must be (z > 0) of the
    fmaf order (`hidden_sum.zed_fmaf`, exact) at every slot-channel.
    Prints the mismatches beside the slot-channels whose fmaf z is 0 and
    those within the recheck bound (the case must hold some)."""
    kown, mown, kcross, mcross, u_ext, shift, rown, rcross = args
    q, b, lo = kown.shape
    u = near_zero_u(u_ext, gen)
    ncol = u.shape[0] - 2
    fo = hidden_sum._fields_ext(kown, ~mown, shift, ncol, rown)[..., :ncol]
    fc = hidden_sum._fields_ext(kcross, torch.zeros_like(mcross[0]), shift,
                                ncol, rcross)[..., :ncol]
    qi = torch.arange(q, device=DEVICE)[:, None]
    bi = torch.arange(b, device=DEVICE)
    n_own = mown.sum(dim=-1).clamp(min=1)          # valid slots: a prefix
    n_cross = mcross.any(dim=0).sum(dim=-1).clamp(min=1)
    wrong = zero = near = total = 0
    for _ in range(draws):
        own = (torch.rand(q, b, generator=gen) < 0.5).to(DEVICE)
        at_own = (torch.rand(q, b, generator=gen).to(DEVICE)
                  * n_own).long().clamp(max=lo - 1)
        at_cross = (torch.rand(b, generator=gen).to(DEVICE)
                    * n_cross).long()
        m1 = torch.zeros_like(mown)
        m1[qi, bi, at_own] = own
        c1 = torch.zeros_like(mcross)
        c1[qi, bi, at_cross.expand(q, b)] = ~own
        got = hidden_sum.fused_key_hidden_sum_cuda(kown, m1, kcross, c1, u,
                                                   shift, rown, rcross)
        f = torch.where(own[..., None], fo[qi, bi, at_own],
                        fc[bi, at_cross][None])
        zf = hidden_sum.zed_fmaf(f, u)
        wrong += int(((got > 0) != (zf > 0)).sum())
        zero += int((zf == 0).sum())
        near += int((zf.abs() < k1_near_bound(f, u)).sum())
        total += zf.numel()
    say(f"K1 relu decisions {label}, one slot a set, near-zero weights: "
        f"{wrong} of {total} slot-channels differ from the fmaf order's "
        f"({zero} with fmaf z exactly 0, {near} within the recheck bound) "
        f"{'ok' if wrong == 0 and near > 0 else 'FAIL'}")
    require(near > 0, f"K1 decisions {label}: no z near 0, nothing tested")
    require(wrong == 0, f"K1 decisions {label}: {wrong} relu decisions "
                        f"differ from the fmaf order's")


def k1_odd_q4(joined, u_ext, shift, gen, b=999, lo=203, lc=405):
    """Q=4 (HONet's endpoint count) at odd B, L and Lc, from a lo-only
    batch (`q4_inputs`: set 0 all masked)."""
    kown, mown, kcross, mcross = q4_inputs(joined, u_ext, shift, gen,
                                           b=b)[:4]
    cut = lambda t, n: t[..., :n].contiguous()
    return (cut(kown, lo), cut(mown, lo), cut(kcross, lc), cut(mcross, lc),
            u_ext, shift, None, None)


def k1_wide(gen):
    """K1 on WIDE_BWD_CASES (set 0 all masked). Returns the largest
    error."""
    err = 0.0
    for case in WIDE_BWD_CASES:
        args = wide_args(gen, case)
        err = max(err, k1_compare(args, f"{case[0]}, ncol={case[6] + 1}, "
                                        f"shift {args[5]}", empty_set=True))
    return err


def k1b_call(fn, args, g):
    """A K1 backward version on the forward's operands `args`."""
    return fn(*args[:5], g, *args[5:])


def k1b_compare(args, g, label):
    got = k1b_call(hidden_sum.fused_key_hidden_sum_bwd_cuda, args, g)
    again = k1b_call(hidden_sum.fused_key_hidden_sum_bwd_cuda, args, g)
    want = k1b_call(hidden_sum.fused_key_hidden_sum_bwd_plain, args, g)
    sync()
    ncol = args[4].shape[0] - 2
    require(got.shape == want.shape and bool(torch.isfinite(got).all()),
            f"K1 bwd {label}: bad output")
    same = torch.equal(got.view(torch.int32), again.view(torch.int32))
    err = float((got - want).abs().max())
    scale = want.abs().amax(dim=1, keepdim=True)
    ok = bool(((got - want).abs() <= K1B_TOL * scale).all())
    say(f"K1 bwd {label}: Q,B,L,Lc={tuple(args[0].shape)},"
        f"{args[2].shape[1]} max_abs_err={err:.3e} max|dU|="
        f"{float(scale.max()):.3e}, worst row err/row max="
        f"{float(((got - want).abs() / scale.clamp(min=1e-30)).max()):.3e} "
        f"(tol {K1B_TOL}); masking row zero: "
        f"{bool((got[ncol] == 0).all())}; repeat bit-identical: {same} "
        f"{'ok' if ok and same else 'FAIL'}")
    require(ok, f"K1 bwd {label} disagrees with its plain version")
    require(bool((got[ncol] == 0).all()), f"K1 bwd {label}: masking row")
    require(same, f"K1 bwd {label}: two launches differ")
    return err


def k1b_bound(args, g):
    kown, mown, kcross, mcross, u_ext, shift, rown, rcross = args
    ncol, h = u_ext.shape[0] - 2, u_ext.shape[1]
    moved = nbytes(kown, mown, kcross, mcross, u_ext, rown, rcross, g) \
        + u_ext.numel() * 4
    # a slot's activation is recomputed once if any endpoint selects it
    # (ncol multiply-adds and a compare per channel); where it passes the
    # relu, ncol + 1 multiply-adds go into dU (this run's data decides)
    csel = mcross.any(dim=0)
    zo = hidden_sum._fields_ext(kown, ~mown, shift, ncol, rown) @ u_ext
    zc = hidden_sum._fields_ext(kcross, torch.zeros_like(kcross), shift,
                                ncol, rcross) @ u_ext
    passed = int(((zo > 0) & mown[..., None]).sum()) \
        + int(((zc > 0) & csel[..., None]).sum())
    del zo, zc
    computed = int(mown.sum()) + int(csel.sum())
    ops = computed * h * (2 * ncol + 1) + passed * 2 * (ncol + 1)
    return bound(moved, ops)


def contraction_tc_ms(entries, h, ncol):
    """The backwards' dU contraction, 2 (ncol + 1) H operations a slot
    (side) that enters it, in two TF32 products at the TF32 tensor rate,
    in ms (the kernels take one product for a bf16 cotangent)."""
    return 2 * entries * 2 * (ncol + 1) * h / TF32_OPS_PER_S * 1e3


def k1b_tc_ms(args):
    """K1 bwd's contraction at the TF32 rate: every selected slot."""
    kown, mown, kcross, mcross, u_ext = args[:5]
    entries = int(mown.sum()) + int(mcross.any(dim=0).sum())
    return contraction_tc_ms(entries, u_ext.shape[1], u_ext.shape[0] - 2)


def wide_keys(shape, num_walks, num_steps, root_plane, gen, full=False):
    """Packed lo keys of `num_steps` count fields of bit_length(num_walks)
    bits each (up to num_walks, or up to the field's largest value with
    `full`) and the root: a bit above them, or an int32 0/1 plane with
    `root_plane`; a fifth of the keys 0. Drawn from `gen` (CPU)."""
    shift = int(num_walks).bit_length()
    top = (1 << shift) if full else num_walks + 1
    k = torch.zeros(shape, dtype=torch.int64)
    for j in range(num_steps):
        k |= torch.randint(0, top, shape, generator=gen) << (j * shift)
    root = torch.randint(0, 2, shape, generator=gen, dtype=torch.int32)
    if not root_plane:
        k |= root.to(torch.int64) << (num_steps * shift)
    zero = torch.rand(shape, generator=gen) < 0.2
    k[zero] = 0
    root[zero] = 0
    k = torch.where(k >= 2 ** 31, k - 2 ** 32, k).to(torch.int32)
    return k.to(DEVICE), (root.to(DEVICE) if root_plane else None)


def wide_u_ext(ncol, h, num_walks, gen):
    """u_ext [ncol + 2, H] of the bench Net's scale: field rows over
    num_walks, the masking row, b1."""
    w = torch.randn(ncol, h, generator=gen) * (0.5 / num_walks)
    return torch.cat([w, torch.full((1, h), NEG),
                      torch.randn(1, h, generator=gen) * 0.1]).to(
        DEVICE).contiguous()


# The backwards' shapes beyond the bench Net's (keys drawn from a seed):
# label, Q, B, L, H, num_walks, num_steps (ncol = num_steps + 1), root
# plane, fields over their whole width. "shift 12" takes the instance whose
# fields are not exact in TF32 (split in two parts).
WIDE_BWD_CASES = (("H=100", 2, 512, 301, 100, 100, 3, False, False),
                  ("H=1024", 2, 64, 301, 1024, 100, 3, False, False),
                  ("eight fields", 2, 256, 301, 96, 10, 7, False, False),
                  ("shift 12", 2, 256, 301, 96, 2048, 2, False, True),
                  ("shift 12, root plane", 2, 256, 301, 96, 2048, 2, True,
                   True))


def wide_args(gen, case):
    """K1's operands for a WIDE_BWD_CASES case, drawn from `gen`: the cross
    plane 2L wide, each endpoint selecting a random part of it, set 0 all
    masked."""
    label, q, b, ell, h, nw, ns, root, full = case
    kown, rown = wide_keys((q, b, ell), nw, ns, root, gen, full)
    kcross, rcross = wide_keys((b, 2 * ell), nw, ns, root, gen, full)
    mown = (torch.rand(q, b, ell, generator=gen) < 0.4).to(DEVICE)
    pick = torch.randint(0, q + 2, (b, 2 * ell), generator=gen)
    mcross = torch.stack([pick == i for i in range(q)]).to(DEVICE)
    mown[:, 0] = False
    mcross[:, 0] = False
    return (kown, mown, kcross, mcross, wide_u_ext(ns + 1, h, nw, gen),
            int(nw).bit_length(), rown, rcross)


def k1b_wide(gen):
    """K1 bwd on WIDE_BWD_CASES (`wide_args`): the K1 bwd checks of
    `k1b_compare`. Returns the largest error."""
    err = 0.0
    for case in WIDE_BWD_CASES:
        args = wide_args(gen, case)
        g = torch.randn(case[1], case[2], case[4], generator=gen).to(DEVICE)
        err = max(err, k1b_compare(args, g, f"{case[0]}, ncol={case[6] + 1}"
                                            f", shift {args[5]}"))
    return err


def q4_inputs(joined, u_ext, shift, gen, b=256):
    """A small Q=4 case (HONet's endpoint count) from a lo-only batch:
    endpoints 2, 3 reuse other queries' rows, every endpoint selects a
    random half of the cross plane, and set 0 is all masked."""
    b = min(b, joined.kown.shape[1])
    pair = lambda t: torch.cat([t, t.roll(1, dims=1)])[:, :b].contiguous()
    kown, mown = pair(joined.kown), pair(joined.mask)
    kcross = joined.kcross[:b].contiguous()
    mcross = (torch.rand(4, b, kcross.shape[1], generator=gen) < 0.5).to(
        DEVICE)
    mown[:, 0] = False
    mcross[:, 0] = False
    return kown, mown, kcross, mcross, u_ext, shift, None, None


def attn_inputs(joined, u_ext, shift, gen):
    """The attention pool's operands on a join: its slot-aligned planes,
    u_ext, and gv = [gvec; gconst] at about the scale of the bench Net's
    folded gate (W2 @ wg)."""
    gv = torch.cat([torch.randn(HIDDEN, 1, generator=gen) * 0.3,
                    torch.full((1, 1), 0.2)]).to(DEVICE)
    return (joined.kown, joined.kcross_al, joined.mask, u_ext, gv, shift,
            joined.kown_root, joined.kcross_al_root)


def attn_odd(args, b=999, ell=203):
    """B and L that are not multiples of 32: a corner of a batch (slot 0
    of a set is valid whenever the set is, so no set goes empty)."""
    cut = lambda t: None if t is None else t[:, :b, :ell].contiguous()
    kown, kc, mask, u_ext, gv, shift, ro, rc = args
    return (cut(kown), cut(kc), cut(mask), u_ext, gv, shift, cut(ro),
            cut(rc))


def attn_q4(args, b=256):
    """Q=4 (HONet's endpoint count): endpoints 2, 3 reuse other queries'
    rows."""
    quad = lambda t: torch.cat([t, t.roll(1, dims=1)])[:, :b].contiguous()
    kown, kc, mask, u_ext, gv, shift, _, _ = args
    return quad(kown), quad(kc), quad(mask), u_ext, gv, shift, None, None


def attn_mask_kinds(args, gen):
    """The operands with each row's mask replaced, by row number mod 5:
    kept (the join's prefix); holes, a random half of the prefix kept and
    slots 32-95 cleared (whole tiles walked past inside a row); valid only
    in the last 32-slot tile (a random half of it and its last slot);
    valid only at slot 0; no valid slot (uniform weights over all L)."""
    kown, kc, mask, u_ext, gv, shift, ro, rc = args
    q, b, ell = mask.shape
    kind = (torch.arange(b, device=mask.device) % 5)[None, :, None]
    slot = torch.arange(ell, device=mask.device)
    coin = (torch.rand(q, b, ell, generator=gen) < 0.5).to(mask.device)
    last = (ell - 1) // attn_pool.TILE * attn_pool.TILE
    holes = mask & coin & ((slot < 32) | (slot >= 96))
    holes[..., 0] = True
    tail = (coin & (slot >= last)) | (slot == ell - 1)
    first = (slot == 0).expand_as(mask)
    none = torch.zeros_like(mask)
    masks = torch.where(kind == 0, mask, torch.where(
        kind == 1, holes, torch.where(kind == 2, tail, torch.where(
            kind == 3, first, none))))
    return (kown, kc, masks.contiguous(), u_ext, gv, shift, ro, rc)


def attn_widest(args, rows=2):
    """The longest operands the wrappers take at the operands' hidden
    width (Q=1): the largest L whose backward block of one warp fits
    (`attn_pool.bwd_smem_bytes`), made of the first `rows` sets of `args`
    repeated along the slots (their prefix masks repeat: holes across
    many tiles)."""
    kown, kc, mask, u_ext, gv, shift, ro, rc = args
    h, ncol = u_ext.shape[1], u_ext.shape[0] - 2
    ell = attn_pool.MAX_DYN_SMEM // 8
    while attn_pool.bwd_smem_bytes(ell, h, ncol) > attn_pool.MAX_DYN_SMEM:
        ell -= 1
    reps = -(-ell // kown.shape[2])
    tile = lambda t: None if t is None else t[:1, :rows].repeat(
        1, 1, reps)[..., :ell].contiguous()
    return (tile(kown), tile(kc), tile(mask), u_ext, gv, shift, tile(ro),
            tile(rc))


def attn_label(args, label):
    kown, mask = args[0], args[2]
    return (f"{label}: Q,B,L={tuple(kown.shape)} valid slots "
            f"{float(mask.float().mean()):.3f}, rows with none "
            f"{int((~mask.any(dim=-1)).sum())}")


def attn_compare(args, label):
    got, gm, gs = attn_pool.fused_attn_pool_cuda(*args)
    again = attn_pool.fused_attn_pool_cuda(*args)
    want, wm, ws = attn_pool.fused_attn_pool_plain(*args)
    sync()
    require(got.shape == want.shape and bool(torch.isfinite(got).all())
            and bool(torch.isfinite(gs).all()), f"K3 {label}: bad output")
    same = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip((got, gm, gs), again))
    err = float((got - want).abs().max())
    close = lambda x, y: torch.allclose(x, y, rtol=ATTN_RTOL, atol=ATTN_ATOL)
    ok = close(got, want) and close(gm, wm) and close(gs, ws)
    say(f"K3 {attn_label(args, label)}; max_abs_err={err:.3e} "
        f"max|plain|={float(want.abs().max()):.3e}, m err "
        f"{float((gm - wm).abs().max()):.3e}, s err "
        f"{float(((gs - ws) / ws).abs().max()):.3e} relative (rtol "
        f"{ATTN_RTOL}, atol {ATTN_ATOL}); repeat bit-identical: {same} "
        f"{'ok' if ok and same else 'FAIL'}")
    require(ok, f"K3 {label} disagrees with its plain version")
    require(same, f"K3 {label}: two launches differ")
    return err


def attn_bwd_call(fn, args, g, m, s):
    """An attention backward version on the forward's operands `args`."""
    return fn(*args[:5], g, m, s, *args[5:])


def attn_bwd_scales(args, g, m, s):
    """The sizes of the terms whose sums give dgvec and dgconst. Both add
    up dgate = a * (da - t), which sums to 0 over each set (the softmax's
    VJP), so their rounding error follows the terms a * (|da| + |t|)
    (times hs for dgvec), not the result: ([H], scalar)."""
    *_, hs, gate = attn_pool.attn_slots_plain(*args)
    a = torch.exp(gate - m[..., None]) / s[..., None]
    da = (hs * g[:, :, None, :]).sum(dim=-1)
    t = (a * da).sum(dim=-1, keepdim=True)
    w = a * (da.abs() + t.abs())
    return (w[..., None] * hs).sum(dim=(0, 1, 2)), w.sum()


def attn_bwd_compare(args, g, label):
    """Both versions on the kernel forward's residuals m, s: dU within
    ATTN_BWD_TOL of each row's largest magnitude; dgvec and dgconst,
    sums of terms that cancel, within ATTN_CANCEL_TOL of their terms'
    sizes (attn_bwd_scales)."""
    _, m, s = attn_pool.fused_attn_pool_cuda(*args)
    got = attn_bwd_call(attn_pool.fused_attn_pool_bwd_cuda, args, g, m, s)
    again = attn_bwd_call(attn_pool.fused_attn_pool_bwd_cuda, args, g, m, s)
    want = attn_bwd_call(attn_pool.fused_attn_pool_bwd_plain, args, g, m, s)
    sync()
    h = args[3].shape[1]
    require(all(x.shape == y.shape and bool(torch.isfinite(x).all())
                for x, y in zip(got, want)), f"K3 bwd {label}: bad output")
    same = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(got, again))
    row_max = want[0].abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
    du_rel = float(((got[0] - want[0]).abs() / row_max).max())
    scale_v, scale_c = attn_bwd_scales(args, g, m, s)
    dv = (got[1] - want[1]).abs()[:, 0]
    v_rel = float((dv[:h] / scale_v.clamp(min=1e-30)).max())
    c_rel = float(dv[h] / scale_c)
    ok = (du_rel <= ATTN_BWD_TOL and v_rel <= ATTN_CANCEL_TOL
          and c_rel <= ATTN_CANCEL_TOL)
    err = max(float((got[0] - want[0]).abs().max()), float(dv.max()))
    say(f"K3 bwd {attn_label(args, label)}; max_abs_err={err:.3e} "
        f"max|dU|={float(want[0].abs().max()):.3e}, worst dU err/row max="
        f"{du_rel:.3e} (tol {ATTN_BWD_TOL}); max|dgvec|="
        f"{float(want[1][:h].abs().max()):.3e}, worst dgvec err/terms "
        f"{v_rel:.3e}, dgconst {float(got[1][h]):.3e} vs "
        f"{float(want[1][h]):.3e}, err/terms {c_rel:.3e} (tol "
        f"{ATTN_CANCEL_TOL}); repeat bit-identical: {same} "
        f"{'ok' if ok and same else 'FAIL'}")
    require(ok, f"K3 bwd {label} disagrees with its plain version")
    require(same, f"K3 bwd {label}: two launches differ")
    return err


def attn_bound(args):
    """The forward's least time. A masked slot weighs exactly 0, so only
    valid slots need their hidden row: per channel two z's of ncol
    multiply-adds and a bias add each, two relus and their sum, the gate's
    multiply-add and the pool's; per slot the exp and the sum."""
    kown, kc, mask, u_ext, gv, _, ro, rc = args
    q, b, _ = kown.shape
    ncol, h = u_ext.shape[0] - 2, u_ext.shape[1]
    moved = nbytes(kown, kc, mask, u_ext, gv, ro, rc) + q * b * (h + 2) * 4
    valid = int(mask.sum())
    ops = valid * (h * (2 * (2 * ncol + 1) + 3 + 2 + 2) + 2)
    return bound(moved, ops)


def attn_bwd_bound(args, g):
    """The backward's least time: per valid slot and channel, the hidden
    row again, the gate's and da's multiply-adds, dhs (3) and dgvec's
    multiply-add; where a side's z > 0, its 2 ncol + 1 operations into dU;
    per valid slot the weight, t and dgate (8)."""
    kown, kc, mask, u_ext, gv, shift, ro, rc = args
    q, b, _ = kown.shape
    ncol, h = u_ext.shape[0] - 2, u_ext.shape[1]
    moved = nbytes(kown, kc, mask, u_ext, gv, ro, rc, g) + 2 * q * b * 4 \
        + (u_ext.numel() + gv.numel()) * 4
    _, _, zo, zc, _, _ = attn_pool.attn_slots_plain(*args)
    vm = mask[..., None]
    passed = int(((zo > 0) & vm).sum()) + int(((zc > 0) & vm).sum())
    del zo, zc
    valid = int(mask.sum())
    ops = valid * (h * (2 * (2 * ncol + 1) + 3 + 2 + 2 + 3 + 2) + 8) \
        + passed * (2 * ncol + 1)
    return bound(moved, ops)


def attn_vs_plain(t_lo, t_hi, g2, gen):
    """K3 and K3 bwd against their plain versions: both layouts, an odd
    shape, Q=4, in both layouts every mask kind (attn_mask_kinds), and
    the longest L the wrappers take at H=96 (attn_widest); then their
    times at L=301 (the kernels line's) and at L=801, where the TPU
    needs its slot-chunked kernels."""
    kinds = torch.Generator().manual_seed(3)   # leaves gen's draws as were
    cases = ((t_lo, f"lo-only M={NUM_WALKS} S'={NUM_STEPS}", gen),
             (t_hi, f"lead-in-hi M={WIDE_WALKS} S'={WIDE_STEPS}", gen),
             (attn_odd(t_lo), "odd B and L, lo-only", gen),
             (attn_q4(t_lo), "Q=4, lo-only", gen),
             (attn_mask_kinds(t_lo, kinds), "mask kinds, lo-only", kinds),
             (attn_mask_kinds(t_hi, kinds), "mask kinds, lead-in-hi",
              kinds),
             (attn_widest(t_lo), f"widest L at H={HIDDEN}, lo-only", kinds))
    err3 = max(attn_compare(a, label) for a, label, _ in cases)
    err3b = 0.0
    for a, label, cot in cases:
        ga = torch.randn(a[0].shape[0], a[0].shape[1], HIDDEN,
                         generator=cot).to(DEVICE)
        err3b = max(err3b, attn_bwd_compare(a, ga, label))
    del cases
    stats = {}
    for name, t in (("L=301", t_lo), ("L=801", t_hi)):
        _, m, s = attn_pool.fused_attn_pool_cuda(*t)
        fwd = (time_ms(lambda: attn_pool.fused_attn_pool_cuda(*t)),
               time_ms(lambda: attn_pool.fused_attn_pool_plain(*t),
                       iters=5), attn_bound(t))
        bwd = (time_ms(lambda: attn_bwd_call(
                   attn_pool.fused_attn_pool_bwd_cuda, t, g2, m, s)),
               time_ms(lambda: attn_bwd_call(
                   attn_pool.fused_attn_pool_bwd_plain, t, g2, m, s),
                       iters=5), attn_bwd_bound(t, g2))
        for what, (ms, plain_ms, (bound_ms, by)) in (("K3", fwd),
                                                     ("K3 bwd", bwd)):
            say(f"{what} {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                f"ms, bound {bound_ms:.4f} ms ({by}), "
                f"{ms / bound_ms:.1f}x the bound")
        if t is t_lo:
            stats["attn_pool_fwd"] = dict(
                max_abs_err=err3, ms=fwd[0], plain_ms=fwd[1],
                library_ms=None, bound=fwd[2])
            stats["attn_pool_bwd"] = dict(
                max_abs_err=err3b, ms=bwd[0], plain_ms=bwd[1],
                library_ms=None, bound=bwd[2])
    return stats


def lstm_inputs(joined, u_ext, shift, gen):
    """K4's operands on a join: its slot-aligned planes, u_ext, and the
    folded weights wi_eff [96, 384], wh [96, 384], bh_eff [384] at a scale
    that keeps the gates out of saturation (|gate| about 0.5)."""
    w = lambda *s: (torch.randn(*s, generator=gen) * 0.1).to(DEVICE)
    return (joined.kown, joined.kcross_al, joined.mask, u_ext,
            w(HIDDEN, 4 * HIDDEN), w(HIDDEN, 4 * HIDDEN), w(4 * HIDDEN),
            shift, joined.kown_root, joined.kcross_al_root)


def lstm_cut(args, b=None, ell=None, q4=False, holes=None, ends=False):
    """A variant of K4's operands: the first b rows and ell slots; or Q=4
    (endpoints 2, 3 reuse other queries' rows); or the mask with holes
    punched in (`holes`, a generator); or, with `ends`, set (0, 0) empty
    and set (0, 1) valid only at its last slot."""
    kown, kc, mask, u_ext, wi, wh, bh, shift, ro, rc = args
    b = kown.shape[1] if b is None else b
    ell = kown.shape[2] if ell is None else ell
    cut = lambda t: None if t is None else t[:, :b, :ell].contiguous()
    if q4:
        cut = lambda t: None if t is None else torch.cat(
            [t, t.roll(1, dims=1)])[:, :b, :ell].contiguous()
    kown, kc, mask, ro, rc = (cut(t) for t in (kown, kc, mask, ro, rc))
    if holes is not None:
        mask = mask & (torch.rand(mask.shape, generator=holes) < 0.7).to(
            DEVICE)
    if ends:
        mask = mask.clone()
        mask[0, :2] = False
        mask[0, 1, -1] = True
    return kown, kc, mask, u_ext, wi, wh, bh, shift, ro, rc


def lstm_widen(args, gen, hh):
    """K4's operands at LSTM width and input width hh: u_ext's columns
    repeated, fresh weights at a scale that keeps |gate| about 0.5."""
    kown, kc, mask, u_ext, _, _, _, shift, ro, rc = args
    u = u_ext.repeat(1, -(-hh // u_ext.shape[1]))[:, :hh].contiguous()
    w = lambda *s: (torch.randn(*s, generator=gen) * 0.05).to(DEVICE)
    return (kown, kc, mask, u, w(hh, 4 * hh), w(hh, 4 * hh), w(4 * hh),
            shift, ro, rc)


def lstm_label(args, label):
    kown, mask = args[0], args[2]
    ell = mask.shape[-1]
    prefix = torch.equal(mask, torch.arange(ell, device=mask.device)
                         < mask.sum(dim=-1, keepdim=True))
    return (f"{label}: Q,B,L,H={tuple(kown.shape)},{args[5].shape[0]} "
            f"valid slots {float(mask.float().mean()):.3f}, prefix masks "
            f"{prefix}")


def lstm_check(name, cuda, plain, args, mask, label):
    """A forward LSTM kernel (K4 or K5) against its plain version at
    LSTM_TOL; two launches, and a launch in the rows' own order, bit for
    bit; a row with no valid slot (mask) exactly 0."""
    got = cuda(*args)
    again = cuda(*args)
    unsorted = cuda(*args, sort_rows=False)
    trained = cuda(*args, keep_stash=True)[0]
    want = plain(*args)
    sync()
    require(got.shape == want.shape and bool(torch.isfinite(got).all()),
            f"{name} {label}: bad output")
    bits = lambda x: x.view(torch.int32)
    same = torch.equal(bits(got), bits(again))
    same_order = torch.equal(bits(got), bits(unsorted))
    same_train = torch.equal(bits(got), bits(trained))
    del trained
    empty = ~mask.any(dim=-1)
    zero = bool((got[empty] == 0).all())
    err = float((got - want).abs().max())
    ok = torch.allclose(got, want, rtol=LSTM_TOL, atol=LSTM_TOL)
    fine = ok and same and same_order and same_train and zero
    say(f"{name} {label}; max_abs_err={err:.3e} max|plain|="
        f"{float(want.abs().max()):.3e} (rtol = atol = {LSTM_TOL}); repeat "
        f"bit-identical: {same}; unsorted rows bit-identical: {same_order};"
        f" training instance (stash kept) bit-identical: {same_train}; "
        f"{int(empty.sum())} empty rows exactly 0: {zero} "
        f"{'ok' if fine else 'FAIL'}")
    require(ok, f"{name} {label} disagrees with its plain version")
    require(same and same_order, f"{name} {label}: launches differ")
    require(same_train, f"{name} {label}: the training forward's final h "
                        "differs from serving's")
    require(zero, f"{name} {label}: an empty row is not 0")
    return err


def lstm_compare(args, label):
    return lstm_check("K4", lstm_keys.lstm_from_keys_cuda,
                      lstm_keys.lstm_from_keys_plain, args, args[2],
                      lstm_label(args, label))


def lstm_bound(args):
    """K4's least time. Only a valid slot moves the carry, so only valid
    (row, slot) pairs need work: the two hidden rows (per channel and side
    ncol multiply-adds, the bias, the relu; their sum), the gate product
    4H (h + H) multiply-adds, and the cell, LSTM_CELL_OPS per unit."""
    kown, kc, mask, u_ext, wi, wh, bh, _, ro, rc = args
    q, b, _ = kown.shape
    ncol, h = u_ext.shape[0] - 2, u_ext.shape[1]
    hh = wh.shape[0]
    moved = nbytes(kown, kc, mask, u_ext, wi, wh, bh, ro, rc) + q * b * hh * 4
    per_slot = (h * (2 * (2 * ncol + 2) + 1) + 2 * 4 * hh * (h + hh)
                + LSTM_CELL_OPS * hh)
    return bound(moved, int(mask.sum()) * per_slot)


def cudnn_lstm(args):
    """`cudnn_lstm_x` on K4's hidden rows, materialized."""
    kown, kc, mask, u_ext, wi, wh, bh, shift, ro, rc = args
    q, b, ell = kown.shape
    x = hidden_sum.fused_key_hidden_slots_plain(kown, kc, u_ext, shift,
                                                root_own=ro, root_cross=rc)
    return cudnn_lstm_x(x.reshape(q * b, ell, -1), mask.reshape(q * b, ell),
                        wi, wh, bh)


def cudnn_lstm_x(x, rows, wi, wh, bh):
    """torch.nn.LSTM (cuDNN, TF32 off) with weight_ih = wi^T, weight_hh =
    wh^T, bias_ih = 0, bias_hh = bh, and the rows x [R, L, h] packed by
    length: the yardsticks' recurrence alone, x given. Needs prefix masks
    `rows` [R, L]. Returns (the module, the packed rows)."""
    ell = rows.shape[1]
    lengths = rows.sum(dim=-1)
    require(torch.equal(rows, torch.arange(ell, device=DEVICE)
                        < lengths[:, None]),
            "the yardstick needs prefix masks")
    packed = torch.nn.utils.rnn.pack_padded_sequence(
        x, lengths.cpu(), batch_first=True, enforce_sorted=False)
    lstm = torch.nn.LSTM(x.shape[2], wh.shape[0], batch_first=True).to(
        DEVICE)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(wi.T)
        lstm.weight_hh_l0.copy_(wh.T)
        lstm.bias_ih_l0.zero_()
        lstm.bias_hh_l0.copy_(bh)
    return lstm, packed


def lstm_library(args):
    """The yardstick of K4: `cudnn_lstm`'s forward. Returns a call giving
    [Q, B, H]."""
    q, b, _ = args[0].shape
    lstm, packed = cudnn_lstm(args)

    @torch.no_grad()
    def run():
        return lstm(packed)[1][0][0].reshape(q, b, -1)

    return run


def lstm_cases(jlo, jhi, u_lo, u_hi, shift_lo, shift_hi, gen):
    """K4's and K4 bwd's operands: cases (a)-(g), and (a), (b) by name."""
    l_lo = lstm_inputs(jlo, u_lo, shift_lo, gen)
    l_hi = lstm_inputs(jhi, u_hi, shift_hi, gen)
    odd = lstm_cut(l_lo, b=999, ell=203)
    cases = ((l_lo, f"(a) lo-only M={NUM_WALKS} S'={NUM_STEPS}"),
             (l_hi, f"(b) lead-in-hi M={WIDE_WALKS} S'={WIDE_STEPS}"),
             (odd, "(c) odd B and L, lo-only"),
             (lstm_cut(l_lo, b=256, q4=True), "(d) Q=4, lo-only"),
             (lstm_cut(l_lo, holes=torch.Generator().manual_seed(6)),
              "(e) holes in the masks, lo-only"),
             (lstm_cut(odd, ends=True),
              "(f) an empty row, a row valid at its last slot only"),
             (lstm_widen(lstm_cut(l_lo, b=512), gen, lstm_keys.MAX_H),
              f"(g) H={lstm_keys.MAX_H}, lo-only"))
    return cases, {"L=301": l_lo, "L=801": l_hi}


def lstm_vs_plain(cases, wide):
    """Phase 2 for K4: cases (a)-(g) against the plain version, and the
    kernel, plain, cuDNN and bound times at L=301 and L=801."""
    torch.cuda.reset_peak_memory_stats()
    err = max(lstm_compare(a, label) for a, label in cases)
    out = {}
    for name, args in wide.items():
        lib = lstm_library(args)
        got, want = lib(), lstm_keys.lstm_from_keys_plain(*args)
        lib_err = float((got - want).abs().max())
        require(torch.allclose(got, want, rtol=LSTM_TOL, atol=LSTM_TOL),
                f"cuDNN's LSTM disagrees with K4's plain version at {name}")
        del got, want
        ms = time_ms(lambda: lstm_keys.lstm_from_keys_cuda(*args))
        ms_unsorted = time_ms(lambda: lstm_keys.lstm_from_keys_cuda(
            *args, sort_rows=False))
        plain_ms = time_ms(lambda: lstm_keys.lstm_from_keys_plain(*args),
                           iters=5)
        lib_ms = time_ms(lib)
        bound_ms, by = lstm_bound(args)
        say(f"K4 {name}: kernel {ms:.4f} ms (rows in their own order "
            f"{ms_unsorted:.4f} ms), plain {plain_ms:.4f} ms, cuDNN LSTM "
            f"(recurrence only, x given) {lib_ms:.4f} ms with max |d| "
            f"{lib_err:.3e} from plain, bound {bound_ms:.4f} ms ({by})")
        del lib
        kown, mask, u_ext, wh = args[0], args[2], args[3], args[5]
        q, b, ell = kown.shape
        fwd_times(f"K4 {name}", ms,
                  lambda: lstm_keys.lstm_from_keys_cuda(*args,
                                                        keep_stash=True),
                  cudnn_lstm(args), (bound_ms, by),
                  fwd_tc_ms(int(mask.sum()), u_ext.shape[1], wh.shape[0]),
                  mask.reshape(q * b, ell), u_ext.shape[1], wh.shape[0],
                  u_ext.shape[0] - 2)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound=(bound_ms, by))
    say(f"K4 checks peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return dict(max_abs_err=err, **out["L=301"])


def fwd_tc_ms(valid, h, hh):
    """The forward's gate products, 2 4H (h + H) operations a valid (row,
    slot), in 3xTF32 (three TF32 products each) at the TF32 tensor rate,
    in ms."""
    return 3 * valid * 2 * 4 * hh * (h + hh) / TF32_OPS_PER_S * 1e3


def fwd_times(name, ms, train, cudnn, bound_, tc_ms, mask, h, hh, ncol):
    """A forward's serving (ms, timed by the caller) and training instance
    beside cuDNN's forward and training forward (its module and packed
    rows), in the same call; its bounds; the longest block's step count
    (the rows in `row_order`, blocks of `block_layout`'s rows) and the
    blocks an SM holds (shared memory bounds it)."""
    lstm, packed = cudnn
    train_ms = time_ms(train)
    with torch.no_grad():
        lib_ms = time_ms(lambda: lstm(packed))
    lib_fwd = cudnn_train(lstm, packed, torch.zeros(
        packed.batch_sizes[0], hh, device=DEVICE))[0]
    lib_train_ms = time_ms(lib_fwd)
    lay = lstm_keys.block_layout(h, hh, ncol)
    ends = lstm_keys.row_ends(mask)
    steps = ends[lstm_keys.row_order(mask, ends).long()]
    per_block = steps[::lay["rows"]]
    per_sm = (228 * 1024) // (lay["smem"] + 1024)
    bound_ms, by = bound_
    stash_ms, stash_by = stash_fwd_bound(bound_ms, int(mask.sum()), hh)
    say(f"{name} forward: serving {ms:.4f} ms (cuDNN forward {lib_ms:.4f} "
        f"ms), training instance {train_ms:.4f} ms (cuDNN training forward "
        f"{lib_train_ms:.4f} ms); bound {bound_ms:.4f} ms ({by}; training "
        f"{stash_ms:.4f} ms, {stash_by}), its products in 3xTF32 at the "
        f"TF32 tensor rate {tc_ms:.4f} ms; {per_block.numel()} blocks of "
        f"{lay['rows']} rows (resident wh: {lay['resident']}, "
        f"{lay['smem']} bytes of shared memory, {per_sm} a SM), the longest "
        f"block {int(per_block.max())} steps, mean "
        f"{float(per_block.float().mean()):.1f}")
    del lib_fwd
    return train_ms, lib_train_ms


def lstm_bwd_call(fn, args, g):
    """K4 bwd's plain version on K4's operands `args` and the cotangent
    g."""
    return fn(*args[:7], g, *args[7:])


def lstm_stash(args, sort_rows=True):
    """K4's training forward on `args`: the stash it keeps."""
    return lstm_keys.lstm_from_keys_cuda(*args, sort_rows=sort_rows,
                                         keep_stash=True)[1]


def lstm_bwd_from(args, g, stash):
    """K4 bwd from a training forward's stash."""
    return lstm_keys.lstm_from_keys_bwd_cuda(*args[:7], g, *args[7:],
                                             stash=stash)


def lstm_train_bwd(args, g, sort_rows=True):
    """K4's training forward, then K4 bwd from its stash."""
    return lstm_bwd_from(args, g, lstm_stash(args, sort_rows))


def time_after_ms(prep, fn, iters: int = TIMED_ITERS) -> float:
    """Median device time of fn(prep()) in ms, without prep's: the L2
    flushed after prep and before each timed run."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=DEVICE)
    fn(prep())
    sync()
    times = []
    for _ in range(iters):
        x = prep()
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(x)
        end.record()
        sync()
        times.append(start.elapsed_time(end))
        del x
    return float(np.median(times))


def lstm_cotangent(args, gen):
    kown, wh = args[0], args[5]
    return torch.randn(kown.shape[0], kown.shape[1], wh.shape[0],
                       generator=gen).to(DEVICE)


def lstm_bwd_compare(args, g, label):
    """K4 bwd, from the stash of K4's training forward, against its plain
    version: each of (du, dwi, dwh, dbh) within LSTM_BWD_TOL of that
    tensor's largest entry, with the rows sorted and in their own order
    (other summation orders); two launches bit for bit; dU's masking row
    exactly 0; rows with no valid slot contribute nothing (a cotangent of
    1e3 there leaves every bit)."""
    got = lstm_train_bwd(args, g)
    again = lstm_train_bwd(args, g)
    unsorted = lstm_train_bwd(args, g, sort_rows=False)
    empty = ~args[2].any(dim=-1)
    loud = lstm_train_bwd(args, torch.where(empty[..., None], 1e3, g))
    want = lstm_bwd_call(lstm_keys.lstm_from_keys_bwd_plain, args, g)
    sync()
    require(all(x.shape == y.shape and bool(torch.isfinite(x).all())
                for x, y in zip(got, want)), f"K4 bwd {label}: bad output")
    bits = lambda xs, ys: all(torch.equal(x.view(torch.int32),
                                          y.view(torch.int32))
                              for x, y in zip(xs, ys))
    same, silent = bits(got, again), bits(got, loud)
    rel = [rel_err(x, y) for x, y in zip(got, want)]
    rel_unsorted = [rel_err(x, y) for x, y in zip(unsorted, want)]
    ncol = args[3].shape[0] - 2
    neg_zero = bool((got[0][ncol] == 0).all())
    err = max(float((x - y).abs().max()) for x, y in zip(got, want))
    ok = max(rel + rel_unsorted) <= LSTM_BWD_TOL
    fmt = lambda v: "/".join(f"{x:.2e}" for x in v)
    say(f"K4 bwd {lstm_label(args, label)}; max_abs_err={err:.3e}; "
        f"err/max by du/dwi/dwh/dbh {fmt(rel)} (rows unsorted "
        f"{fmt(rel_unsorted)}; tol {LSTM_BWD_TOL}); max|plain| "
        f"{fmt([float(y.abs().max()) for y in want])}; repeat "
        f"bit-identical: {same}; masking row 0: {neg_zero}; "
        f"{int(empty.sum())} empty rows silent: {silent} "
        f"{'ok' if ok and same and neg_zero and silent else 'FAIL'}")
    require(ok, f"K4 bwd {label} disagrees with its plain version")
    require(same, f"K4 bwd {label}: two launches differ")
    require(neg_zero, f"K4 bwd {label}: masking row of dU")
    require(silent, f"K4 bwd {label}: an empty row contributes")
    return err


def relu_passed(args):
    """The (valid slot, side, channel) triples whose hidden value passes
    the relu, from this run's keys."""
    kown, kc, mask, u_ext, _, _, _, shift, ro, rc = args
    ncol = u_ext.shape[0] - 2
    passed = 0
    for keys, roots in ((kown, ro), (kc, rc)):
        for i in range(kown.shape[0]):  # one endpoint at a time
            z = hidden_sum._fields_ext(
                keys[i], torch.zeros_like(mask[i]), shift, ncol,
                None if roots is None else roots[i]) @ u_ext
            passed += int(((z > 0) & mask[i, ..., None]).sum())
            del z
    return passed


def bwd_products(valid, h, hh):
    """Operations of the backward's four products per valid (row, slot):
    dh_prev = dgates wh^T, dx = dgates wi^T, dwi += x^T dgates, dwh +=
    h_prev^T dgates, 2 4H (h + H) each pair."""
    return valid * 2 * 2 * 4 * hh * (h + hh)


def stash_bytes(valid, hh):
    """The stash a valid (row, slot) needs: gates 4H, c and h H each."""
    return valid * 6 * hh * 4


def lstm_bwd_bound(args, g):
    """K4 bwd's least time, from the valid (row, slot) pairs: the products
    dh_prev, dx, dwi, dwh (`bwd_products`), the cell's backward
    (LSTM_CELL_BWD_OPS per unit), the hidden rows again for dwi (per
    channel and side 2 ncol + 2 operations and the relu) and 2 (ncol + 1)
    into dU for each side and channel that passes the relu (this run's
    data decides); the stash read once (`stash_bytes`), the keys, g and
    the weights read and the gradients written. Also returns the products'
    time on the tensor cores in 3xTF32 (three TF32 products each)."""
    kown, kc, mask, u_ext, wi, wh, bh, shift, ro, rc = args
    ncol, h = u_ext.shape[0] - 2, u_ext.shape[1]
    hh = wh.shape[0]
    valid = int(mask.sum())
    moved = nbytes(kown, kc, mask, u_ext, wi, wh, bh, ro, rc, g) \
        + nbytes(u_ext, wi, wh, bh) + stash_bytes(valid, hh)
    prods = bwd_products(valid, h, hh)
    ops = (prods + valid * (h * (2 * (2 * ncol + 2) + 1)
                            + LSTM_CELL_BWD_OPS * hh)
           + relu_passed(args) * 2 * (ncol + 1))
    return bound(moved, ops), 3 * prods / TF32_OPS_PER_S * 1e3


def stash_fwd_bound(fwd_bound_ms, valid, hh):
    """The training forward's least time: the serving forward's (its
    operations bound it) or the stash written once, whichever is
    longer."""
    t_bytes = stash_bytes(valid, hh) / HBM_BYTES_PER_S * 1e3
    return max(fwd_bound_ms, t_bytes), (
        "bytes" if t_bytes > fwd_bound_ms else "operations")


def cudnn_train(lstm, packed, g):
    """cuDNN's LSTM training pair (`cudnn_lstm_x`'s module and packed
    rows), with the packed rows as a leaf: (the training forward, which
    keeps cuDNN's reserve space, as a call; the backward of sum(g * h_n)
    for the rows and the weights, as a call taking that forward's output;
    its (dwi, dwh, dbh) in the port's orientation)."""
    leaf = torch.nn.utils.rnn.PackedSequence(
        packed.data.requires_grad_(), packed.batch_sizes,
        packed.sorted_indices, packed.unsorted_indices)
    wrt = [leaf.data, lstm.weight_ih_l0, lstm.weight_hh_l0, lstm.bias_hh_l0]

    def fwd():
        return lstm(leaf)[1][0][0]

    def bwd(hn):
        return torch.autograd.grad(hn, wrt, grad_outputs=g.reshape(hn.shape))

    _, dwih, dwhh, dbhh = bwd(fwd())
    return fwd, bwd, (dwih.T, dwhh.T, dbhh)


def bwd_times(name, stash, bwd, plain, lib_fwd, lib_bwd, fwd_bound_ms,
              bound_, tc_ms, valid, hh):
    """Times of a backward (K4 bwd or K5 bwd) and its training forward:
    the stash forward alone, the backward alone from a fresh stash (rows
    sorted and in their own order), the pair, the plain version, cuDNN's
    training forward and backward, and the bounds."""
    fwd_ms = time_ms(stash)
    ms = time_after_ms(stash, bwd)
    ms_unsorted = time_after_ms(lambda: stash(False), bwd)
    pair_ms = time_ms(lambda: bwd(stash()))
    plain_ms = time_ms(plain, iters=5)
    lib_fwd_ms = time_ms(lib_fwd)
    lib_ms = time_after_ms(lib_fwd, lib_bwd)
    (bound_ms, by) = bound_
    fb_ms, fb_by = stash_fwd_bound(fwd_bound_ms, valid, hh)
    say(f"{name}: backward {ms:.4f} ms from the training forward's stash "
        f"(rows in their own order {ms_unsorted:.4f} ms), bound "
        f"{bound_ms:.4f} ms ({by}; its products in 3xTF32 at the TF32 "
        f"tensor rate {tc_ms:.4f} ms); training forward (stash kept) "
        f"{fwd_ms:.4f} ms, bound {fb_ms:.4f} ms ({fb_by}); the pair "
        f"{pair_ms:.4f} ms; plain {plain_ms:.4f} ms; cuDNN LSTM training "
        f"forward {lib_fwd_ms:.4f} ms, backward {lib_ms:.4f} ms, pair "
        f"{lib_fwd_ms + lib_ms:.4f} ms")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound=bound_, stash_fwd_ms=fwd_ms, pair_ms=pair_ms)


def lstm_bwd_vs_plain(cases, wide, gen):
    """Phase 2 for K4 bwd: cases (a)-(g) against the plain version, and
    the times and bounds of the backward, the training forward, their
    pair, the plain version and cuDNN's training pair at L=301 and
    L=801."""
    torch.cuda.reset_peak_memory_stats()
    err = max(lstm_bwd_compare(a, lstm_cotangent(a, gen), label)
              for a, label in cases)
    out = {}
    for name, args in wide.items():
        g = lstm_cotangent(args, gen)
        lib_fwd, lib_bwd, lib_grads = cudnn_train(*cudnn_lstm(args), g)
        want = lstm_bwd_call(lstm_keys.lstm_from_keys_bwd_plain, args, g)
        lib_rel = [rel_err(x, y) for x, y in zip(lib_grads, want[1:])]
        del want, lib_grads
        say(f"K4 bwd {name}: cuDNN's dwi/dwh/dbh within "
            f"{'/'.join(f'{r:.2e}' for r in lib_rel)} of plain's largest "
            f"entries")
        bound_, tc_ms = lstm_bwd_bound(args, g)
        out[name] = bwd_times(
            f"K4 bwd {name}", lambda s=True: lstm_stash(args, s),
            lambda st: lstm_bwd_from(args, g, st),
            lambda: lstm_bwd_call(lstm_keys.lstm_from_keys_bwd_plain, args,
                                  g),
            lib_fwd, lib_bwd, lstm_bound(args)[0], bound_, tc_ms,
            int(args[2].sum()), args[5].shape[0])
        del lib_fwd, lib_bwd
    say(f"K4 bwd checks peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return dict(max_abs_err=err, **out["L=301"])


def groups_vs_whole(name, loss, leaves, rows, ell, hh):
    """An LSTM Function's gradients of `loss()` for `leaves`, its training
    stash whole and in row groups (`lstm_keys.STASH_BUDGET` lowered to a
    quarter of the stash for the call): each grouped gradient within
    LSTM_BWD_TOL of the whole one's largest entry."""
    def grads():
        for t in leaves:
            t.grad = None
        loss().backward()
        return [t.grad.clone() for t in leaves]

    whole = grads()
    keep = lstm_keys.STASH_BUDGET
    blocks = -(-rows // lstm_keys.STASH_ROWS)
    lstm_keys.STASH_BUDGET = (4 * lstm_keys.STASH_ROWS * ell * 6 * hh
                              * (blocks // 4))
    try:
        group = lstm_keys.stash_group(rows, ell, hh)
        split = grads()
    finally:
        lstm_keys.STASH_BUDGET = keep
    rel = [rel_err(a, b) for a, b in zip(split, whole)]
    ok = max(rel) <= LSTM_BWD_TOL and group < rows
    say(f"{name}: gradients with the stash in groups of {group} rows "
        f"({-(-rows // group)} groups) against the whole stash's "
        f"({rows} rows): err/max {'/'.join(f'{r:.2e}' for r in rel)} (tol "
        f"{LSTM_BWD_TOL}) {'ok' if ok else 'FAIL'}")
    require(ok, f"{name}: the grouped backward disagrees with the whole")


def lstm_groups(args, gen):
    """`groups_vs_whole` for the keys-LSTM (FusedKeysLSTM: K4, K4 bwd)."""
    kown, kc, mask, u_ext, wi, wh, bh, shift, ro, rc = args
    q, b, ell = kown.shape
    leaves = [t.clone().requires_grad_() for t in (u_ext, wi, wh, bh)]
    g = lstm_cotangent(args, gen)
    groups_vs_whole(
        "FusedKeysLSTM L=301",
        lambda: (lstm_keys.lstm_from_keys(kown, kc, mask, *leaves, shift,
                                          root_own=ro, root_cross=rc)
                 * g).sum(), leaves, q * b, ell, wh.shape[0])


def lstm_x_groups(args, gen):
    """`groups_vs_whole` for the LSTM over given rows (FinalHiddenLSTM:
    K5, K5 bwd; dx written group by group)."""
    x, mask, wi, wh, bh = args
    leaves = [t.clone().requires_grad_() for t in (x, wi, wh, bh)]
    g = lstm_x_cotangent(args, gen)
    groups_vs_whole(
        "FinalHiddenLSTM L=301",
        lambda: (lstm_x.lstm_final_hidden(leaves[0], mask, *leaves[1:])
                 * g).sum(), leaves, x.shape[0], x.shape[1], wh.shape[0])


def table_x(spgk, rows, gen):
    """K5's operands on the encoding-table path's real input: the sets of
    `spgk` deduplicated (`dedup_device`), the batch `rows` [2, B] joined
    by `gather_join`, x = h[e_own] + h[e_cross] [2B, L, 96] fp32 with
    h = relu(enc @ w1 + b1) a seeded hidden layer over the table, the
    join's masks, and weights at a scale that keeps |gate| about 0.5."""
    eidx, enc, _ = dedup_device(spgk.sizes, spgk.khi, spgk.klo,
                                spgk.num_walks, spgk.num_steps)
    joined = gather_join(spgk.nodes, eidx, spgk.sizes, rows)
    w1 = (torch.randn(enc.shape[1], HIDDEN, generator=gen) * 0.5).to(DEVICE)
    b1 = (torch.randn(HIDDEN, generator=gen) * 0.1).to(DEVICE)
    htable = torch.relu(enc @ w1 + b1)
    x = htable[joined.eidx[..., 0]] + htable[joined.eidx[..., 1]]
    q, b, ell = joined.mask.shape
    w = lambda *s: (torch.randn(*s, generator=gen) * 0.1).to(DEVICE)
    return (x.reshape(q * b, ell, HIDDEN), joined.mask.reshape(q * b, ell),
            w(HIDDEN, 4 * HIDDEN), w(HIDDEN, 4 * HIDDEN), w(4 * HIDDEN))


def table_x_cut(args, b=None, ell=None, holes=None, ends=False):
    """A variant of K5's operands: the first b queries of both endpoints
    and ell slots; or the mask with holes punched in (`holes`, a
    generator); or, with `ends`, row 0 empty and row 1 valid only at its
    last slot."""
    x, mask, wi, wh, bh = args
    if b is not None or ell is not None:
        r, full, h = x.shape
        cut = lambda t: t.reshape(2, r // 2, full, -1)[:, :b, :ell]
        x = cut(x).reshape(-1, ell or full, h).contiguous()
        mask = cut(mask).reshape(x.shape[:2]).contiguous()
    if holes is not None:
        mask = mask & (torch.rand(mask.shape, generator=holes) < 0.7).to(
            DEVICE)
    if ends:
        mask = mask.clone()
        mask[:2] = False
        mask[1, -1] = True
    return x, mask, wi, wh, bh


def table_x_widen(args, gen, hh, rows=1024):
    """K5's operands at LSTM width and input width hh: the first `rows`
    rows, x's channels repeated, fresh weights at a scale that keeps
    |gate| about 0.5."""
    x, mask = args[0][:rows], args[1][:rows].contiguous()
    x = x.repeat(1, 1, -(-hh // x.shape[2]))[..., :hh].contiguous()
    w = lambda *s: (torch.randn(*s, generator=gen) * 0.05).to(DEVICE)
    return x, mask, w(hh, 4 * hh), w(hh, 4 * hh), w(4 * hh)


def table_x_label(args, label):
    x, mask = args[0], args[1]
    return (f"{label}: R,L,h,H={tuple(x.shape)},{args[3].shape[0]} valid "
            f"slots {float(mask.float().mean()):.3f}")


def lstm_x_bound(args):
    """K5's least time. Only a valid slot moves the carry, so only valid
    (row, slot) pairs need work: the gate product 4H (h + H) multiply-adds
    and the cell, LSTM_CELL_OPS per unit; and only their x rows need
    reading, with the mask and the weights once and the output written."""
    x, mask, wi, wh, bh = args
    r, _, h = x.shape
    hh = wh.shape[0]
    valid = int(mask.sum())
    moved = valid * h * 4 + nbytes(mask, wi, wh, bh) + r * hh * 4
    return bound(moved, valid * (2 * 4 * hh * (h + hh) + LSTM_CELL_OPS * hh))


def table_x_cases(spl, spw, rows, gen):
    """K5's and K5 bwd's operands on the table path's input: cases
    (a)-(f), and (a), (b) by name."""
    x_lo = table_x(spl, rows, gen)
    x_hi = table_x(spw, rows, gen)
    odd = table_x_cut(x_lo, b=999, ell=203)
    cases = ((x_lo, f"(a) table path M={NUM_WALKS} S'={NUM_STEPS}"),
             (x_hi, f"(b) table path M={WIDE_WALKS} S'={WIDE_STEPS}"),
             (odd, "(c) odd B and L"),
             (table_x_cut(x_lo, holes=torch.Generator().manual_seed(7)),
              "(d) holes in the masks"),
             (table_x_cut(odd, ends=True),
              "(e) an empty row, a row valid at its last slot only"),
             (table_x_widen(x_lo, gen, lstm_keys.MAX_H),
              f"(f) h = H = {lstm_keys.MAX_H}"))
    return cases, {"L=301": x_lo, "L=801": x_hi}


def lstm_x_vs_plain(cases, wide):
    """Phase 2 for K5: cases (a)-(f) against the plain version, and the
    kernel, plain, cuDNN and bound times at L=301 and L=801."""
    torch.cuda.reset_peak_memory_stats()
    err = max(lstm_check("K5", lstm_x.lstm_final_hidden_cuda,
                         lstm_x.lstm_final_hidden_plain, a, a[1],
                         table_x_label(a, label)) for a, label in cases)
    out = {}
    for name, args in wide.items():
        lstm, packed = cudnn_lstm_x(*args)

        @torch.no_grad()
        def lib(lstm=lstm, packed=packed):
            return lstm(packed)[1][0][0]

        got, want = lib(), lstm_x.lstm_final_hidden_plain(*args)
        lib_err = float((got - want).abs().max())
        require(torch.allclose(got, want, rtol=LSTM_TOL, atol=LSTM_TOL),
                f"cuDNN's LSTM disagrees with K5's plain version at {name}")
        del got, want
        ms = time_ms(lambda: lstm_x.lstm_final_hidden_cuda(*args))
        ms_unsorted = time_ms(lambda: lstm_x.lstm_final_hidden_cuda(
            *args, sort_rows=False))
        plain_ms = time_ms(lambda: lstm_x.lstm_final_hidden_plain(*args),
                           iters=5)
        lib_ms = time_ms(lib)
        bound_ms, by = lstm_x_bound(args)
        say(f"K5 {name}: kernel {ms:.4f} ms (rows in their own order "
            f"{ms_unsorted:.4f} ms), plain {plain_ms:.4f} ms, cuDNN LSTM "
            f"(x given) {lib_ms:.4f} ms with max |d| {lib_err:.3e} from "
            f"plain, bound {bound_ms:.4f} ms ({by}); valid slots "
            f"{int(args[1].sum())}")
        x, mask, wh = args[0], args[1], args[3]
        fwd_times(f"K5 {name}", ms,
                  lambda: lstm_x.lstm_final_hidden_cuda(*args,
                                                        keep_stash=True),
                  (lstm, packed), (bound_ms, by),
                  fwd_tc_ms(int(mask.sum()), x.shape[2], wh.shape[0]),
                  mask, x.shape[2], wh.shape[0], None)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound=(bound_ms, by))
        del lstm, packed, lib
    say(f"K5 checks peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return dict(max_abs_err=err, **out["L=301"])


def lstm_x_cotangent(args, gen):
    return torch.randn(args[0].shape[0], args[3].shape[0],
                       generator=gen).to(DEVICE)


def lstm_x_stash(args, sort_rows=True):
    """K5's training forward on `args`: the stash it keeps."""
    return lstm_x.lstm_final_hidden_cuda(*args, sort_rows=sort_rows,
                                         keep_stash=True)[1]


def lstm_x_train_bwd(args, g, sort_rows=True):
    """K5's training forward, then K5 bwd from its stash."""
    return lstm_x.lstm_final_hidden_bwd_cuda(
        *args, g, stash=lstm_x_stash(args, sort_rows))


def lstm_x_bwd_compare(args, g, label):
    """K5 bwd, from the stash of K5's training forward, against its plain
    version: each of (dx, dwi, dwh, dbh) within LSTM_BWD_TOL of that
    tensor's largest entry, with the rows sorted and in their own order
    (other summation orders); two launches bit for bit; dx exactly 0 at
    every masked slot; rows with no valid slot contribute nothing (a
    cotangent of 1e3 there leaves every bit)."""
    bits = lambda xs, ys: all(torch.equal(x.view(torch.int32),
                                          y.view(torch.int32))
                              for x, y in zip(xs, ys))
    mask = args[1]
    empty = ~mask.any(dim=-1)
    want = lstm_x.lstm_final_hidden_bwd_plain(*args, g)
    got = lstm_x_train_bwd(args, g)
    same = bits(got, lstm_x_train_bwd(args, g))
    rel_unsorted = [rel_err(x, y) for x, y in
                    zip(lstm_x_train_bwd(args, g, sort_rows=False), want)]
    silent = bits(got, lstm_x_train_bwd(
        args, torch.where(empty[:, None], 1e3, g)))
    sync()
    require(all(x.shape == y.shape and bool(torch.isfinite(x).all())
                for x, y in zip(got, want)), f"K5 bwd {label}: bad output")
    rel = [rel_err(x, y) for x, y in zip(got, want)]
    dx_peak = got[0].abs().amax(dim=-1)                        # [R, L]
    masked_zero = bool((dx_peak[~mask] == 0).all())
    err = max(float((x - y).abs().max()) for x, y in zip(got, want))
    ok = max(rel + rel_unsorted) <= LSTM_BWD_TOL
    fmt = lambda v: "/".join(f"{x:.2e}" for x in v)
    say(f"K5 bwd {table_x_label(args, label)}; max_abs_err={err:.3e}; "
        f"err/max by dx/dwi/dwh/dbh {fmt(rel)} (rows unsorted "
        f"{fmt(rel_unsorted)}; tol {LSTM_BWD_TOL}); max|plain| "
        f"{fmt([float(y.abs().max()) for y in want])}; repeat "
        f"bit-identical: {same}; dx at {int((~mask).sum())} masked slots "
        f"exactly 0: {masked_zero}; {int(empty.sum())} empty rows silent: "
        f"{silent} "
        f"{'ok' if ok and same and masked_zero and silent else 'FAIL'}")
    require(ok, f"K5 bwd {label} disagrees with its plain version")
    require(same, f"K5 bwd {label}: two launches differ")
    require(masked_zero, f"K5 bwd {label}: dx at a masked slot is not 0")
    require(silent, f"K5 bwd {label}: an empty row contributes")
    return err


def lstm_x_bwd_bound(args, g):
    """K5 bwd's least time, from the valid (row, slot) pairs: the products
    dh_prev, dx, dwi, dwh (`bwd_products`) and the cell's backward
    (LSTM_CELL_BWD_OPS per unit); the stash read once (`stash_bytes`), the
    valid slots' x, the mask, the weights and g read, dx (every slot) and
    the weight gradients written. Also returns the products' time on the
    tensor cores in 3xTF32."""
    x, mask, wi, wh, bh = args
    r, ell, h = x.shape
    hh = wh.shape[0]
    valid = int(mask.sum())
    moved = valid * h * 4 + nbytes(mask, wi, wh, bh, g) \
        + r * ell * h * 4 + nbytes(wi, wh, bh) + stash_bytes(valid, hh)
    prods = bwd_products(valid, h, hh)
    return (bound(moved, prods + valid * LSTM_CELL_BWD_OPS * hh),
            3 * prods / TF32_OPS_PER_S * 1e3)


def lstm_x_bwd_vs_plain(cases, wide, gen):
    """Phase 2 for K5 bwd: cases (a)-(f) against the plain version, and
    the times and bounds of the backward, the training forward, their
    pair, the plain version and cuDNN's training pair at L=301 and
    L=801."""
    torch.cuda.reset_peak_memory_stats()
    err = max(lstm_x_bwd_compare(a, lstm_x_cotangent(a, gen), label)
              for a, label in cases)
    out = {}
    plain = lstm_x.lstm_final_hidden_bwd_plain
    for name, args in wide.items():
        g = lstm_x_cotangent(args, gen)
        lib_fwd, lib_bwd, lib_grads = cudnn_train(*cudnn_lstm_x(*args), g)
        want = plain(*args, g)
        lib_rel = [rel_err(x, y) for x, y in zip(lib_grads, want[1:])]
        del want, lib_grads
        say(f"K5 bwd {name}: cuDNN's dwi/dwh/dbh within "
            f"{'/'.join(f'{r:.2e}' for r in lib_rel)} of plain's largest "
            f"entries (its backward gives dx too)")
        bound_, tc_ms = lstm_x_bwd_bound(args, g)
        out[name] = bwd_times(
            f"K5 bwd {name}", lambda s=True: lstm_x_stash(args, s),
            lambda st: lstm_x.lstm_final_hidden_bwd_cuda(*args, g,
                                                         stash=st),
            lambda: plain(*args, g), lib_fwd, lib_bwd,
            lstm_x_bound(args)[0], bound_, tc_ms, int(args[1].sum()),
            args[3].shape[0])
        del lib_fwd, lib_bwd
    say(f"K5 bwd checks peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return dict(max_abs_err=err, **out["L=301"])


def merge_rows(nodes, pays):
    """The join's merge operands from a batch's rows [2, B, L], as the
    join forms them: (v keys, v payload, u keys, u payload)."""
    nu, nv = nodes[0].to(torch.int64), nodes[1].to(torch.int64)
    return (walk_ops.to_bits(nv << 1), pays[1].contiguous(),
            walk_ops.to_bits((nu << 1) | 1), pays[0].contiguous())


def random_merge_rows(rng, rows, la, lb):
    ka = np.sort(rng.integers(0, 1 << 31, size=(rows, la)) * 2, axis=1)
    kb = np.sort(rng.integers(0, 1 << 31, size=(rows, lb)) * 2 + 1, axis=1)
    ka[:, la // 2:] = 0xFFFFFFFE            # padded tail, payload 0
    pa = rng.integers(-(1 << 31), 1 << 31, size=(rows, la))
    pa[:, la // 2:] = 0
    pb = rng.integers(-(1 << 31), 1 << 31, size=(rows, lb))
    t = lambda x: walk_ops.to_bits(torch.as_tensor(x).to(DEVICE))
    return t(ka), torch.as_tensor(pa, dtype=torch.int32).to(DEVICE), \
        t(kb), torch.as_tensor(pb, dtype=torch.int32).to(DEVICE)


def tied_merge_rows(rng, rows, la, lb, top):
    """Ascending rows of keys drawn from [0, top) on both sides (many equal
    keys within and across a and b), distinct payloads."""
    ka = np.sort(rng.integers(0, top, size=(rows, la)), axis=1)
    kb = np.sort(rng.integers(0, top, size=(rows, lb)), axis=1)
    pa = np.arange(rows * la).reshape(rows, la)
    pb = np.arange(rows * lb).reshape(rows, lb) + rows * la
    t = lambda x: torch.as_tensor(x, dtype=torch.int32).to(DEVICE)
    return t(ka), t(pa), t(kb), t(pb)


def k2_compare(args, label):
    """K2 against its plain version exactly, two launches bit for bit."""
    kg, pg = merge.merge_pairs_cuda(*args)
    ka, pa = merge.merge_pairs_cuda(*args)
    kw, pw = merge.merge_pairs_plain(*args)
    sync()
    err = max(int((walk_ops.u32(kg) - walk_ops.u32(kw)).abs().max()),
              int((pg.to(torch.int64) - pw.to(torch.int64)).abs().max()))
    same = torch.equal(kg, ka) and torch.equal(pg, pa)
    say(f"K2 {label}: [{args[0].shape[0]}, {args[0].shape[1]}] + "
        f"[{args[2].shape[0]}, {args[2].shape[1]}] max_abs_err={err}; "
        f"repeat bit-identical: {same} "
        f"{'exact' if err == 0 and same else 'FAIL'}")
    require(err == 0, f"K2 {label} differs from its plain version")
    require(same, f"K2 {label}: two launches differ")
    return err


def launch_spread(name, label, wrapper, direct):
    """A kernel's launch times: min, median and max of TIMED_ITERS launches
    of `wrapper` with the L2 flushed before each by zeroing a 128 MB buffer
    (which leaves it dirty in L2), issued as they come (the way `time_ms`
    times) and queued behind a device wait (`queue_ahead`); queued, with
    the L2 flushed by reading that buffer (clean lines); and queued through
    `direct` (the kernel's C entry called on outputs allocated once); then
    the mean of 200 back-to-back launches, queued and without a flush
    (inputs and outputs L2-resident after the first), by the wrapper and
    by the direct call. `name` and `label` head the printed lines."""
    buf = torch.empty(128 << 20, dtype=torch.uint8, device=DEVICE)
    ways = {"zeroed flush, as issued": (wrapper, buf.zero_, False),
            "zeroed flush, queued": (wrapper, buf.zero_, True),
            "read flush, queued": (wrapper, lambda: buf.max(), True),
            "zeroed flush, queued, outputs allocated once": (
                direct, buf.zero_, True)}
    out = {}
    for way, (fn, flush, queued) in ways.items():
        t = launch_times(fn, TIMED_ITERS, flush, queued)
        out[way] = (min(t), float(np.median(t)), max(t))
        say(f"{name} spread {label}, {way}: min {out[way][0]:.4f}, median "
            f"{out[way][1]:.4f}, max {out[way][2]:.4f} ms over {len(t)} "
            f"launches; sorted: " + " ".join(f"{x:.4f}" for x in sorted(t)))
    for way, fn in (("wrapper", wrapper), ("direct call", direct)):
        mean = launch_times(fn, 200)[0]
        out[f"back to back, {way}"] = mean
        say(f"{name} spread {label}: mean of 200 back-to-back launches, "
            f"queued, no flush, {way}: {mean:.4f} ms")
    return out


def k2_direct(args):
    """K2's C entry on `args`, its outputs allocated once."""
    ka, pa, kb, pb = args
    rows, la = ka.shape
    lb = kb.shape[1]
    ko = torch.empty(rows, la + lb, dtype=torch.int32, device=DEVICE)
    po = torch.empty_like(ko)
    return lambda: merge.KERNEL(ka.device, *map(build.ptr, (
        ka, pa, kb, pb, ko, po)), rows, la, lb)


def k2_bound(args):
    ka, _, kb, _ = args
    rows, la = ka.shape
    lb = kb.shape[1]
    moved = 2 * nbytes(*args)                    # inputs once, outputs once
    # one binary search per element in the other row
    ops = rows * (la * math.ceil(math.log2(lb + 1))
                  + lb * math.ceil(math.log2(la + 1)))
    return bound(moved, ops)


def k6_rows(spgk, rows):
    """K6's operands on a join's rows [2, B, L] of `spgk`: (nodes_u,
    nodes_v, hi_u, lo_u, hi_v, lo_v)."""
    n, hi, lo = spgk.nodes[rows], spgk.khi[rows], spgk.klo[rows]
    return tuple(t.contiguous()
                 for t in (n[0], n[1], hi[0], lo[0], hi[1], lo[1]))


def k6_shapes(spl, spw, rows, gsets):
    """K6's operands at the three timed shapes: the join rows of the
    lo-only and lead-in-hi batches and of the general layout's sets."""
    gspgk, grows = gsets
    return {"[4096, 301]": k6_rows(spl, rows),
            "[4096, 801]": k6_rows(spw, rows),
            "[2048, 4001]": k6_rows(gspgk, grows)}


def k6_variant(args, b=None, ell=None, words=None):
    """K6's operands cut to the first b rows and ell slots (sets stay
    sets), or with payload words drawn over all 32 bits from `words` (a
    generator)."""
    cut = tuple(t[:b, :ell].contiguous() for t in args)
    if words is None:
        return cut
    draw = lambda: torch.randint(-(1 << 31), 1 << 31, cut[0].shape,
                                 generator=words,
                                 dtype=torch.int32).to(DEVICE)
    return (*cut[:2], *(draw() for _ in range(4)))


def k6_tied(gen, rows, ell, top):
    """K6's operands on ascending rows whose nodes repeat: ids drawn from
    [0, top) (runs within a row, common nodes across u and v), 0 to ell
    valid slots a row (rows of padding only among them), payload words
    over all 32 bits."""
    def nodes():
        x = torch.randint(0, top, (rows, ell), generator=gen).sort(dim=1)
        n = torch.randint(0, ell + 1, (rows, 1), generator=gen)
        return torch.where(torch.arange(ell) < n, x.values,
                           walk_ops.INT32_MAX).to(torch.int32)
    draw = lambda: torch.randint(-(1 << 31), 1 << 31, (rows, ell),
                                 generator=gen, dtype=torch.int32)
    return tuple(t.to(DEVICE) for t in (nodes(), nodes(), draw(), draw(),
                                        draw(), draw()))


def k6_padded(args):
    """K6's operands with every 5th row of u and every 7th of v padding
    only (every 35th both)."""
    nu, nv = args[0].clone(), args[1].clone()
    nu[::5] = walk_ops.INT32_MAX
    nv[::7] = walk_ops.INT32_MAX
    return (nu, nv, *args[2:])


def k6_disjoint(args):
    """K6's operands with no node common to u and v: u's ids doubled, v's
    doubled plus one (order and padding kept)."""
    pad = walk_ops.INT32_MAX
    nu, nv = args[0], args[1]
    return (torch.where(nu == pad, nu, 2 * nu),
            torch.where(nv == pad, nv, 2 * nv + 1), *args[2:])


def k6_ascending(args) -> bool:
    """Every node row of K6's operands ascending, checked on the card."""
    return all(bool((x[:, 1:] >= x[:, :-1]).all()) for x in args[:2])


def k6_compare(args, label):
    """K6 against its plain version (the [B, L, L] equality mask, both
    directions), exactly, and two launches bit for bit, on rows checked
    ascending (the kernel's precondition)."""
    require(k6_ascending(args), f"K6 {label}: rows not ascending")
    got = xlookup.cross_lookup_pair_cuda(*args)
    again = xlookup.cross_lookup_pair_cuda(*args)
    want = xlookup.cross_lookup_pair_plain(*args)
    sync()
    exact = all(torch.equal(x, y) for x, y in zip(got, want))
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    found = [int(((got[d] != 0) | (got[d + 1] != 0)).sum()) for d in (0, 2)]
    valid = lambda x: float((x != walk_ops.INT32_MAX).float().mean())
    say(f"K6 {label}: [{args[0].shape[0]}, {args[0].shape[1]}], valid "
        f"slots u {valid(args[0]):.3f}, v {valid(args[1]):.3f}; slots with "
        f"a nonzero payload found u -> v {found[0]}, v -> u {found[1]}; "
        f"both directions equal to plain: {exact}; repeat bit-identical: "
        f"{same} {'exact' if exact and same else 'FAIL'}")
    require(exact, f"K6 {label} differs from its plain version")
    require(same, f"K6 {label}: two launches differ")
    return 0.0


def k6_direct(args):
    """K6's C entry on `args`, its outputs allocated once."""
    rows, ell = args[0].shape
    outs = [torch.empty(rows, ell, dtype=torch.int32, device=DEVICE)
            for _ in range(4)]
    return lambda: xlookup.KERNEL(args[0].device, *map(build.ptr, (
        *args, *outs)), rows, ell)


def k6_timing(name, label, pair, direct):
    """A join's cross lookup `pair` at one shape: its median time as issued
    (`time_ms`) and its launch spread (`launch_spread`), whose queued
    median is the time without the host's launch gap."""
    ms = time_ms(pair)
    spread = launch_spread(name, label, pair, direct)
    return dict(ms=ms, queued=spread["zeroed flush, queued"][1],
                back_to_back=spread["back to back, direct call"])


def k6_library(args):
    """The same lookup on sets through one `torch.searchsorted` a
    direction: the lower bound of each slot's node in the other row, both
    payload words gathered there and kept where the node is found (and is
    not padding). The port never calls it."""
    nu, nv, hu, lu, hv, lv = args
    last = nu.shape[1] - 1

    def one(a, b, hi, lo):
        j = torch.searchsorted(b, a).clamp_(max=last)
        hit = (b.gather(1, j) == a) & (a != walk_ops.INT32_MAX)
        return (torch.where(hit, hi.gather(1, j), 0),
                torch.where(hit, lo.gather(1, j), 0))

    return lambda: (*one(nu, nv, hv, lv), *one(nv, nu, hu, lu))


def sectors(mask) -> int:
    """The 32-byte sectors of a [B, L] 4-byte plane (its base aligned, as
    the allocator's are) that hold a slot where `mask` is true."""
    flat = mask.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, -flat.numel() % 8))
    return int(flat.reshape(-1, 8).any(dim=1).sum())


def k6_bound(args, label=None):
    """K6's least time for a join, from this run's data: the four
    output planes written whole; of the node rows, the sectors up to each
    row's first padding slot (where a row's end is read); of the four
    payload planes, only the sectors that hold a slot found from the other
    row (no search needs the payload of a slot it does not find). The
    operations: a lower-bound search of the other row's valid prefix for
    every valid slot, ceil(log2(n + 1)) steps, both ways, and each row's
    two searches for its valid length. With `label`, prints the bytes."""
    u, v = args[:2]
    rows, ell = u.shape
    pad = walk_ops.INT32_MAX
    slot = torch.arange(ell, device=u.device)
    n = [(x != pad).sum(dim=1) for x in (u, v)]
    ends = sum(sectors(slot <= k[:, None]) for k in n)

    def found(a, b):                     # slots of b holding a node of a
        j = torch.searchsorted(a, b).clamp_(max=ell - 1)
        return (a.gather(1, j) == b) & (b != pad)

    hits = 2 * (sectors(found(u, v)) + sectors(found(v, u)))
    outs = 4 * rows * ell * 4
    moved = 32 * (ends + hits) + outs
    if label is not None:
        say(f"K6 bound {label}: node rows up to each end {32 * ends / 1e6:.3f}"
            f" MB (whole rows {2 * rows * ell * 4 / 1e6:.3f}), payload "
            f"sectors holding a hit {32 * hits / 1e6:.3f} MB (all four "
            f"planes {4 * rows * ell * 4 / 1e6:.3f}), outputs "
            f"{outs / 1e6:.3f} MB")
    steps = lambda m: torch.where(
        m > 0, torch.floor(torch.log2(m.double().clamp(min=1))) + 1, 0)
    ops = float((n[0] * steps(n[1]) + n[1] * steps(n[0])).sum()) \
        + 2 * rows * math.ceil(math.log2(ell + 1))
    return bound(moved, ops)


def general_sets(g):
    """Sets in the general hi/lo key layout (M=1000, S'=4: count fields in
    the hi word) for GEN_SEEDS distinct seeds of the bench graph, and the
    rows [2, GEN_SEEDS / 2] pairing them."""
    seeds = np.random.default_rng(13).choice(g.num_nodes, size=GEN_SEEDS,
                                              replace=False)
    t0 = time.perf_counter()
    spgk = sample_gsets_device_keys(g, seeds, GEN_WALKS, GEN_STEPS, seed=13,
                                    block_size=SAMPLE_BLOCK, device=DEVICE)
    sync()
    lead = walk_ops.enc_field_layout(GEN_WALKS, GEN_STEPS)[2]
    say(f"general-layout sets: {GEN_SEEDS} seeds, M={GEN_WALKS} "
        f"S'={GEN_STEPS} (lead bit {lead}), L={spgk.nodes.shape[1]}, mean "
        f"size {float(spgk.sizes.float().mean()):.1f}, "
        f"{time.perf_counter() - t0:.3f} s")
    require(lead > 32, "the general layout's fields must reach the hi word")
    rows = torch.arange(GEN_SEEDS, device=DEVICE).reshape(2, -1)
    return spgk, rows


def cross_lookup_vs_plain(spl, spw, rows, gsets):
    """Phase 2 for K6, one launch a join: exactly its plain version in both
    directions, two launches bit for bit, on rows checked ascending: the
    join rows of the lo-only [4096, 301] and lead-in-hi [4096, 801]
    batches and of the general layout's sets [2048, 4001], at odd B and L,
    with full 32-bit payload words, on rows whose nodes repeat, rows of
    padding only, rows with no common node and at L=1; times at the three
    shapes as issued and queued (`k6_timing`), beside the bound, the
    `torch.searchsorted` lookup (`k6_library`, held to K6 on the sets),
    and at [4096, 301] the plain version and the merge route's cross
    lookup of the same rows."""
    shapes = k6_shapes(spl, spw, rows, gsets)
    lo = shapes["[4096, 301]"]
    gen = torch.Generator().manual_seed(8)
    layouts = (f"lo-only M={NUM_WALKS} S'={NUM_STEPS}",
               f"lead-in-hi M={WIDE_WALKS} S'={WIDE_STEPS}",
               f"general M={GEN_WALKS} S'={GEN_STEPS}")
    cases = [(a, f"{name}, {shape}")
             for (shape, a), name in zip(shapes.items(), layouts)]
    cases += [(k6_variant(lo, b=999, ell=203), "odd B and L, lo-only"),
              (k6_variant(lo, words=gen), "full 32-bit payload words"),
              (k6_tied(gen, 4096, 301, 64), "repeated nodes, ids below 64"),
              (k6_tied(gen, 1000, 801, 8), "repeated nodes, ids below 8"),
              (k6_padded(lo), "rows of padding only, lo-only"),
              (k6_disjoint(lo), "no common node, lo-only"),
              (k6_variant(lo, ell=1), "L=1, lo-only"),
              (k6_tied(gen, 999, 1, 2), "L=1, ids below 2")]
    err = max(k6_compare(a, label) for a, label in cases)

    cuda = xlookup.cross_lookup_pair_cuda
    times = {}
    for shape, a in shapes.items():
        lib = k6_library(a)
        require(all(torch.equal(x, y) for x, y in zip(lib(), cuda(*a))),
                f"the searchsorted lookup differs from K6 at {shape}")
        t = k6_timing("K6", shape, lambda a=a: cuda(*a), k6_direct(a))
        t["library"] = time_ms(lib)
        t["library_queued"] = queued_ms(lib)
        t["bound"] = k6_bound(a, shape)
        times[shape] = t
        say(f"K6 {shape}, a join (both directions, one launch): as issued "
            f"{t['ms']:.4f} ms, queued {t['queued']:.4f} ms, back to back "
            f"{t['back_to_back']:.4f} ms; bound {t['bound'][0]:.4f} ms "
            f"({t['bound'][1]}); torch.searchsorted lookup as issued "
            f"{t['library']:.4f} ms, queued {t['library_queued']:.4f} ms")
    plain_ms = time_ms(lambda: xlookup.cross_lookup_pair_plain(*lo),
                       iters=5)
    nodes = spl.nodes[rows]
    pays = (spl.khi[rows], spl.klo[rows])
    merge_ms = time_ms(lambda: join_ops._cross_lookup_bidir_multi(
        nodes[0], nodes[1], (pays[0][0], pays[1][0]),
        (pays[0][1], pays[1][1])))
    main = times["[4096, 301]"]
    say(f"K6 lo-only [4096, 301]: a join {main['ms']:.4f} ms, plain "
        f"{plain_ms:.4f} ms, against the merge route's two-word cross "
        f"lookup of the same rows (K2, hit detection, un-sort) "
        f"{merge_ms:.4f} ms")
    return dict(max_abs_err=err, ms=main["ms"], plain_ms=plain_ms,
                library_ms=main["library"], bound=main["bound"])


def k7_inputs(joined, u_ext, shift, out_dtype, b=None, ell=None,
              q4=False):
    """K7's operands on a join's slot-aligned planes: the first b rows and
    ell slots, or Q=4 (endpoints 2, 3 reuse other queries' rows)."""
    cut = lambda t: None if t is None else t[:, :b, :ell].contiguous()
    if q4:
        cut = lambda t: None if t is None else torch.cat(
            [t, t.roll(1, dims=1)])[:, :b, :ell].contiguous()
    return (cut(joined.kown), cut(joined.kcross_al), u_ext, shift,
            out_dtype, cut(joined.kown_root), cut(joined.kcross_al_root))


def k7_label(args, label):
    kown, kc = args[0], args[1]
    return (f"{label}: Q,B,L={tuple(kown.shape)} -> {args[4]}, keys 0: "
            f"own {float((kown == 0).float().mean()):.3f}, partner "
            f"{float((kc == 0).float().mean()):.3f}")


def k7_compare(args, label):
    """K7 against its plain version: fp32 at rtol = atol = 1e-5, bf16
    within one bf16 rounding (both round an fp32 sum once)."""
    got = hidden_sum.fused_key_hidden_slots_cuda(*args)
    want = hidden_sum.fused_key_hidden_slots_plain(*args)
    sync()
    require(got.shape == want.shape and got.dtype == want.dtype
            and bool(torch.isfinite(got).all()), f"K7 {label}: bad output")
    rtol = K7_RTOL[args[4]]
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    ok = bool((diff <= K7_ATOL + rtol * want.float().abs()).all())
    say(f"K7 {k7_label(args, label)}; max_abs_err={err:.3e} max|plain|="
        f"{float(want.float().abs().max()):.3e} (rtol {rtol}, atol "
        f"{K7_ATOL}) {'ok' if ok else 'FAIL'}")
    require(ok, f"K7 {label} disagrees with its plain version")
    return err


def k7b_call(fn, args, g):
    """A K7 bwd version on K7's operands `args` and the cotangent g."""
    kown, kc, u_ext, shift, _, ro, rc = args
    return fn(kown, kc, u_ext, g, shift, ro, rc)


def k7b_compare(args, g, label):
    """K7 bwd against its plain version: dU within 1e-4 of each row's
    largest, the masking row exactly 0, two launches bit for bit."""
    got = k7b_call(hidden_sum.fused_key_hidden_slots_bwd_cuda, args, g)
    again = k7b_call(hidden_sum.fused_key_hidden_slots_bwd_cuda, args, g)
    want = k7b_call(hidden_sum.fused_key_hidden_slots_bwd_plain, args, g)
    sync()
    ncol = args[2].shape[0] - 2
    require(got.shape == want.shape and bool(torch.isfinite(got).all()),
            f"K7 bwd {label}: bad output")
    same = torch.equal(got.view(torch.int32), again.view(torch.int32))
    err = float((got - want).abs().max())
    scale = want.abs().amax(dim=1, keepdim=True)
    ok = bool(((got - want).abs() <= K7B_TOL * scale).all())
    zero = bool((got[ncol] == 0).all())
    say(f"K7 bwd {label}: Q,B,L={tuple(args[0].shape)}, g {g.dtype}: "
        f"max_abs_err={err:.3e} max|dU|={float(scale.max()):.3e}, worst "
        f"row err/row max="
        f"{float(((got - want).abs() / scale.clamp(min=1e-30)).max()):.3e} "
        f"(tol {K7B_TOL}); masking row zero: {zero}; repeat "
        f"bit-identical: {same} {'ok' if ok and zero and same else 'FAIL'}")
    require(ok, f"K7 bwd {label} disagrees with its plain version")
    require(zero, f"K7 bwd {label}: masking row")
    require(same, f"K7 bwd {label}: two launches differ")
    return err


def k7_bound(args):
    """K7's least time: the keys (and root planes) read and the rows
    written once; per slot and channel, ncol multiply-adds and a max on
    each side and one add (no slot is skipped)."""
    kown, kc, u_ext, _, out_dtype, ro, rc = args
    ncol, h = u_ext.shape[0] - 2, u_ext.shape[1]
    n = kown.numel()
    out_bytes = n * h * torch.empty((), dtype=out_dtype).element_size()
    moved = nbytes(kown, kc, u_ext, ro, rc) + out_bytes
    return bound(moved, n * h * (2 * (2 * ncol + 1) + 1))


def k7b_bound(args, g):
    """K7 bwd's least time: the keys and g read, dU written once; per
    slot, side and channel the recomputed z (ncol multiply-adds and a
    compare), and where it passes the relu ncol + 1 multiply-adds into
    dU (this run's data decides)."""
    kown, kc, u_ext, shift, _, ro, rc = args
    ncol, h = u_ext.shape[0] - 2, u_ext.shape[1]
    zero = torch.zeros(kown.shape, dtype=torch.bool, device=kown.device)
    passed = sum(int((hidden_sum._fields_ext(k, zero, shift, ncol, r)
                      @ u_ext > 0).sum()) for k, r in ((kown, ro), (kc, rc)))
    moved = nbytes(kown, kc, u_ext, ro, rc, g) + u_ext.numel() * 4
    ops = kown.numel() * h * 2 * (2 * ncol + 1) + passed * 2 * (ncol + 1)
    return bound(moved, ops)


def k7b_tc_ms(args):
    """K7 bwd's contraction at the TF32 rate: both sides of every slot."""
    kown, u_ext = args[0], args[2]
    return contraction_tc_ms(2 * kown.numel(), u_ext.shape[1],
                             u_ext.shape[0] - 2)


def k7b_wide(gen):
    """K7 bwd on WIDE_BWD_CASES, with a bf16 and an fp32 cotangent: the
    checks of `k7b_compare`. Returns the largest error."""
    err = 0.0
    for label, q, b, ell, h, nw, ns, root, full in WIDE_BWD_CASES:
        if h > 512:
            b = 8
        kown, rown = wide_keys((q, b, ell), nw, ns, root, gen, full)
        kc, rc = wide_keys((q, b, ell), nw, ns, root, gen, full)
        args = (kown, kc, wide_u_ext(ns + 1, h, nw, gen),
                int(nw).bit_length(), torch.bfloat16, rown, rc)
        g = torch.randn(q, b, ell, h, generator=gen).to(DEVICE)
        for gt in (torch.bfloat16, torch.float32):
            err = max(err, k7b_compare(args, g.to(gt), f"{label}, ncol="
                                       f"{ns + 1}, shift {args[3]}"))
    return err


def feature_route(spgk, rows, kcross_al, gen):
    """The feature-pair route K7 replaces, on the same rows: the join's
    unpack of both sides' keys into feature pairs [2, B, L, 2, ncol],
    the hidden layer over them and the pair sum, in bf16 (the bench
    Net's dtype), with W1 and b1 that require a gradient. Returns the
    route and its backward for a cotangent g."""
    pe = make_net("mean", dtype="bfloat16",
                  key=prng.prng_key(2)).pe_embedding
    hi, lo = spgk.khi[rows], spgk.klo[rows]
    params = list(pe.fc0.parameters())

    def forward():
        feats = join_ops._feature_pairs(hi, lo, torch.zeros_like(kcross_al),
                                        kcross_al, NUM_WALKS, NUM_STEPS)
        return pe.hidden(feats).sum(dim=-2)

    def backward(y, g):
        return torch.autograd.grad(y, params, g, retain_graph=True)

    return forward, backward


def hidden_slots_vs_plain(jlo, jhi, u_lo, u_hi, shift_lo, shift_hi, spl,
                          rows, gen):
    """Phase 2 for K7 and K7 bwd: against their plain versions on the
    lo-only [2, 4096, 301] batch (fp32 and bf16 output), the lead-in-hi
    [2, 4096, 801] batch with root planes (both outputs), at B=999, L=203
    and at Q=4; the backward on each with a bf16 and a fp32 cotangent.
    Times at the lo-only batch in bf16 (the bench Net's dtype), beside the
    feature-pair route they replace."""
    bf16, f32 = torch.bfloat16, torch.float32
    lo = lambda dt, **kw: k7_inputs(jlo, u_lo, shift_lo, dt, **kw)
    hi = lambda dt: k7_inputs(jhi, u_hi, shift_hi, dt)
    lo_name = f"lo-only M={NUM_WALKS} S'={NUM_STEPS}"
    hi_name = f"lead-in-hi M={WIDE_WALKS} S'={WIDE_STEPS}"
    cases = [(lo(f32), lo_name), (lo(bf16), lo_name), (hi(f32), hi_name),
             (hi(bf16), hi_name),
             (lo(f32, b=999, ell=203), "odd B and L, lo-only"),
             (lo(bf16, b=256, q4=True), "Q=4, lo-only")]
    err = max(k7_compare(a, label) for a, label in cases)
    dgen = torch.Generator(device=DEVICE).manual_seed(9)
    cot = lambda a: torch.randn(*a[0].shape, a[2].shape[1], generator=dgen,
                                device=DEVICE)
    errb = 0.0
    for a, label in cases[::2] + cases[5:]:      # lo, hi, odd, Q=4
        g = cot(a)
        for gt in (bf16, f32):
            errb = max(errb, k7b_compare(a, g.to(gt), label))
        del g
    # wider shapes, from a generator of their own
    errb = max(errb, k7b_wide(torch.Generator().manual_seed(14)))
    main = cases[1][0]
    g = cot(main).to(bf16)
    cuda, plain = (hidden_sum.fused_key_hidden_slots_cuda,
                   hidden_sum.fused_key_hidden_slots_plain)
    bcuda, bplain = (hidden_sum.fused_key_hidden_slots_bwd_cuda,
                     hidden_sum.fused_key_hidden_slots_bwd_plain)
    ms = time_ms(lambda: cuda(*main))
    plain_ms = time_ms(lambda: plain(*main), iters=5)
    f32_ms = time_ms(lambda: cuda(*cases[0][0]))
    hi_ms = time_ms(lambda: cuda(*cases[3][0]))
    bms = time_ms(lambda: k7b_call(bcuda, main, g))
    bplain_ms = time_ms(lambda: k7b_call(bplain, main, g), iters=5)
    g32 = g.float()
    bf32_ms = time_ms(lambda: k7b_call(bcuda, main, g32))
    # with the cast of g to fp32 inside the timed call, as this script
    # timed the fp32 cotangent before (a 1.4 GB pass of its own)
    bf32_cast_ms = time_ms(lambda: k7b_call(bcuda, main, g.float()))
    del g32
    ghi = cot(cases[3][0]).to(bf16)
    bhi_ms = time_ms(lambda: k7b_call(bcuda, cases[3][0], ghi))
    del ghi
    fwd, bwd = feature_route(spl, rows, jlo.kcross_al, gen)
    route_ms = time_ms(fwd)
    y = fwd()
    route_bwd_ms = time_ms(lambda: bwd(y, g))
    del y
    fb, bb = k7_bound(main), k7b_bound(main, g)
    say(f"K7 lo-only [2, 4096, 301] bf16: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {fb[0]:.4f} ms ({fb[1]}); fp32 output "
        f"{f32_ms:.4f} ms; lead-in-hi [2, 4096, 801] bf16 {hi_ms:.4f} ms; "
        f"the feature-pair route it replaces (unpack, hidden layer, pair "
        f"sum, bf16) {route_ms:.4f} ms")
    bb32 = k7b_bound(main, g.float())
    say(f"K7 bwd lo-only, bf16 g: kernel {bms:.4f} ms, plain "
        f"{bplain_ms:.4f} ms, bound {bb[0]:.4f} ms ({bb[1]}), its "
        f"contraction in two TF32 products at the TF32 tensor rate "
        f"{k7b_tc_ms(main):.4f} ms; fp32 g {bf32_ms:.4f} ms (bound "
        f"{bb32[0]:.4f} ms, {bb32[1]}; with its cast from bf16 in the "
        f"timed call {bf32_cast_ms:.4f} ms); lead-in-hi {bhi_ms:.4f} ms; the "
        f"feature-pair route's backward (W1, b1) {route_bwd_ms:.4f} ms")
    return {"hidden_slots_fwd": dict(max_abs_err=err, ms=ms,
                                     plain_ms=plain_ms, library_ms=None,
                                     bound=fb),
            "hidden_slots_bwd": dict(max_abs_err=errb, ms=bms,
                                     plain_ms=bplain_ms, library_ms=None,
                                     bound=bb)}


def main_batches(g, gen):
    """The lo-only (M=100, S'=3, L=301) and lead-in-hi (M=200, S'=4, L=801:
    root planes) batches and K1's operands on them."""
    spl, rows, jlo = joined_batch(g, NUM_WALKS, NUM_STEPS, seed=11)
    a_lo = k1_inputs(jlo, NUM_WALKS, NUM_STEPS, gen)
    spw, _, jhi = joined_batch(g, WIDE_WALKS, WIDE_STEPS, seed=12)
    require(jhi.kown_root is not None, "lead-in-hi join lost its roots")
    a_hi = k1_inputs(jhi, WIDE_WALKS, WIDE_STEPS, gen)
    return spl, spw, rows, jlo, jhi, a_lo, a_hi


def k1_k2_vs_plain(spl, spw, rows, jlo, a_lo, a_hi):
    """K1 and K2 against their plain versions, their times and bounds, and
    K2's spread (`launch_spread`); returns their stats."""
    gen = torch.Generator().manual_seed(14)  # the later draws stay
    err1 = k1_compare(a_lo, f"lo-only M={NUM_WALKS} S'={NUM_STEPS}")
    err1 = max(err1, k1_compare(a_hi, f"lead-in-hi M={WIDE_WALKS} "
                                      f"S'={WIDE_STEPS}"))
    err1 = max(err1, k1_compare(k1_odd_q4(jlo, a_lo[4], a_lo[5], gen),
                                "Q=4, B=999, L=203, Lc=405, lo-only",
                                empty_set=True))
    err1 = max(err1, k1_wide(gen))
    err1 = max(err1, k1_near_zero(a_lo, gen))
    k1_near_share(a_lo, "lo-only (L=301)")
    k1_near_share(a_hi, "lead-in-hi (L=801)")
    k1_decisions(a_lo, gen, "lo-only (L=301)")
    k1_decisions(a_hi, gen, "lead-in-hi (L=801)")

    m_main = merge_rows(spl.nodes[rows], spl.klo[rows])
    m_hi = merge_rows(spw.nodes[rows], spw.klo[rows])
    err2 = k2_compare(m_main, "join rows, lo-only")
    err2 = max(err2, k2_compare(m_hi, "join rows, lead-in-hi"))
    rng = np.random.default_rng(5)
    for la, lb in ((37, 5), (1, 9), (301, 300)):
        err2 = max(err2, k2_compare(random_merge_rows(rng, 257, la, lb),
                                    f"random odd widths {la}+{lb}"))
    for la, lb, top in ((301, 301, 16), (301, 301, 1), (1, 301, 4),
                        (801, 801, 64)):
        err2 = max(err2, k2_compare(
            tied_merge_rows(rng, 1000, la, lb, top),
            f"ties, keys below {top}, {la}+{lb}"))
    half = merge.MAX_ROW // 2
    err2 = max(err2, k2_compare(random_merge_rows(rng, 64, half, half),
                                f"la + lb = MAX_ROW ({merge.MAX_ROW})"))
    err2 = max(err2, k2_compare(tied_merge_rows(rng, 64, 1, merge.MAX_ROW
                                                - 1, 8),
                                "ties, la = 1, la + lb = MAX_ROW"))

    # times at the main path's shapes
    ka, _, kb, _ = m_main
    cat64 = torch.cat([walk_ops.u32(ka), walk_ops.u32(kb)], dim=1)
    k1_ms = time_ms(lambda: hidden_sum.fused_key_hidden_sum_cuda(*a_lo))
    k1_plain = time_ms(lambda: hidden_sum.fused_key_hidden_sum_plain(*a_lo),
                       iters=5)
    k1_hi_ms = time_ms(lambda: hidden_sum.fused_key_hidden_sum_cuda(*a_hi))
    for name, a, ms in (("lo-only (L=301)", a_lo, k1_ms),
                        ("lead-in-hi (L=801)", a_hi, k1_hi_ms)):
        b_ = k1_bound(a)
        parts = k1_bound_parts(a)
        say(f"K1 {name}: kernel {ms:.4f} ms, bound {b_[0]:.4f} ms ({b_[1]}"
            f"; bytes {parts['bytes_ms']:.4f}, CUDA-core operations "
            f"{parts['cuda_ms']:.4f}, products at the TF32 tensor rate "
            f"k1_tc_ms {parts['k1_tc_ms']:.4f}); the first version's fp32 "
            f"bound {parts['fp32_bound_ms']:.4f} ms")
    k2_ms = time_ms(lambda: merge.merge_pairs_cuda(*m_main))
    k2_plain = time_ms(lambda: merge.merge_pairs_plain(*m_main))
    k2_lib = time_ms(lambda: torch.sort(cat64, dim=1, stable=True))
    k2_hi_ms = time_ms(lambda: merge.merge_pairs_cuda(*m_hi))
    k2_b, k2_hb = k2_bound(m_main), k2_bound(m_hi)
    say(f"K2 lo-only [4096, 301] x 2: kernel {k2_ms:.4f} ms, bound "
        f"{k2_b[0]:.4f} ms ({k2_b[1]}); lead-in-hi [4096, 801] x 2: kernel "
        f"{k2_hi_ms:.4f} ms, bound {k2_hb[0]:.4f} ms ({k2_hb[1]})")
    for args, shape in ((m_main, "[4096, 301] x 2"),
                        (m_hi, "[4096, 801] x 2")):
        launch_spread("K2", shape, lambda a=args: merge.merge_pairs_cuda(*a),
                      k2_direct(args))
    return {"hidden_sum_fwd": dict(
                max_abs_err=err1, ms=k1_ms, plain_ms=k1_plain,
                library_ms=None, bound=k1_bound(a_lo)),
            "merge_pairs": dict(
                max_abs_err=float(err2), ms=k2_ms, plain_ms=k2_plain,
                library_ms=k2_lib, bound=k2_b)}


def threefry_vs_plain(g) -> dict:
    """K8: the known answers (the kernel's words included), the kernel
    against its plain version bit for bit at K8_SIZES and across 2^32,
    two launches alike; sets sampled on the card from a small graph
    against the port's CPU sets from the same inputs (nodes, keys, sizes
    exactly: the CPU sets are what the tests hold to JAX's); its time at a
    sampler block's draw beside its plain version and its bound; and the
    main path's whole draw on K8 beside `torch.randint` of the same shapes
    (the draw the port made before)."""
    tf = threefry
    require(tf.threefry2x32(0, 0, 0, 0) == THREEFRY_KAT,
            "threefry2x32 misses Random123's known answer")
    require(prng.split(prng.prng_key(0), 2) == JAX_SPLIT_KEY0
            and prng.fold_in(prng.prng_key(111413), 7) == JAX_FOLD_111413_7,
            "split or fold_in misses JAX's known answer")
    kat = tf.threefry_bits(0, 0, 0, torch.empty(1, dtype=torch.int64,
                                                device=DEVICE))
    require(int(kat[0]) == THREEFRY_KAT[0] ^ THREEFRY_KAT[1],
            "K8 misses Random123's known answer")
    require(prng.bits(prng.prng_key(0), [8], DEVICE).tolist()
            == list(JAX_BITS_KEY0), "K8 misses jax.random.bits' answer")
    err, cases = 0, [(n, 0) for n in K8_SIZES] + [(4097, K8_HIGH_OFFSET)]
    for i, (n, offset) in enumerate(cases):
        k0, k1 = prng.fold_in(prng.prng_key(i), n)
        out = [tf.threefry_bits(k0, k1, offset, torch.empty(
            n, dtype=torch.int64, device=DEVICE)) for _ in range(2)]
        plain = torch.empty(n, dtype=torch.int64, device=DEVICE)
        tf.threefry_bits_plain(k0, k1, offset, plain)
        same = torch.equal(out[0], plain) and torch.equal(out[0], out[1])
        err = max(err, int((out[0] - plain).abs().max()))
        say(f"K8 n={n} offset={offset}: against plain bit for bit {same}")
        require(same, f"K8 differs from its plain version at n={n}, "
                      f"offset {offset}")
    small = rmat_graph(4000, 40_000, seed=5)
    for nw, ns, n_seeds in ((NUM_WALKS, NUM_STEPS, 4000),
                            (WIDE_WALKS, WIDE_STEPS, 1000)):
        seeds = np.arange(n_seeds)
        card, cpu = (sample_gsets_device_keys(
            small, seeds, nw, ns, seed=3, block_size=1024, device=dev)
            for dev in (DEVICE, "cpu"))
        same = all(torch.equal(getattr(card, k).cpu(), getattr(cpu, k))
                   for k in ("nodes", "khi", "klo", "sizes"))
        say(f"K8 sets on the card against the CPU's (M={nw}, S'={ns}, "
            f"{n_seeds} seeds of a 4,000-node graph): equal {same}")
        require(same, "the card's sets differ from the CPU's")
    n = K8_SIZES[-1]
    out = torch.empty(n, dtype=torch.int64, device=DEVICE)
    ms = time_ms(lambda: tf.threefry_bits_cuda(1, 2, 0, out))
    plain_ms = time_ms(lambda: tf.threefry_bits_plain(1, 2, 0, out), iters=5)
    t = {"bytes": 8 * n / HBM_BYTES_PER_S,
         "operations": THREEFRY_OPS * n / INT32_OPS_PER_S}
    by = max(t, key=t.get)
    # the main path's draw: a block's S' - 1 step draws, every block
    blocks = [min(SAMPLE_BLOCK, g.num_nodes - lo)
              for lo in range(0, g.num_nodes, SAMPLE_BLOCK)]
    key = prng.prng_key(0)
    draw_ms = time_ms(lambda: [walk_ops.walk_bits(key, b, NUM_WALKS,
                                                  NUM_STEPS, DEVICE)
                               for b in blocks])
    randint_ms = time_ms(lambda: [torch.randint(
        0, 1 << 32, (NUM_STEPS - 1, b, NUM_WALKS), dtype=torch.int64,
        device=DEVICE) for b in blocks])
    say(f"K8 at n={n}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{t[by] * 1e3:.4f} ms ({by}; bytes {t['bytes'] * 1e3:.4f} ms, "
        f"operations {t['operations'] * 1e3:.4f} ms); the main path's "
        f"walk draws ({len(blocks)} blocks x {NUM_STEPS - 1} steps x "
        f"{NUM_WALKS} walks, {g.num_nodes} sets): K8 {draw_ms:.4f} ms, "
        f"torch.randint of the same shapes {randint_ms:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound=(t[by] * 1e3, by))


INIT_ULP = 4                         # the card's weights against the CPU's
# the largest |w| / sigma of flax's xavier_normal: 2 / 0.87962566
TRUNC_SIGMAS = 2.2737


def float_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance of two float32 tensors in units in the last
    place (the monotone integer order of their bit patterns)."""
    def order(x):
        i = x.detach().float().cpu().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((order(a) - order(b)).abs().max())


def init_from_key(label, launches) -> None:
    """The weights' initialisation from JAX's key tree on the card:
    Net(96, bf16) mean, attn and lstm, HONet(96) and the LSTM's
    torch_init, from prng_key(0), each against the port's CPU init from
    the same key (the tests hold that to flax's `init`): every xavier
    parameter's truncation uniforms (`prng.uniform` at its key and the
    truncation's bounds) bit for bit, every parameter within INIT_ULP,
    every xavier weight within TRUNC_SIGMAS of its sigma; per model the
    bit-equal share, the largest |w| / sigma and the K8 launches the init
    takes (one a drawn parameter). The keys, shapes and bounds are the
    models' own `draws()`, the list `reset_parameters` draws."""
    key = prng.prng_key(0)

    def lstm_torch_init(device):
        m = LSTMAggregation(HIDDEN, torch_init=True).to(device)
        m.reset_parameters(key)
        return m

    models = {f"Net(96, {x}, bf16)": functools.partial(
        make_net, x, dtype="bfloat16", key=key) for x in ("mean", "attn",
                                                         "lstm")}
    models["HONet(96)"] = functools.partial(HONet, NUM_STEPS + 1, HIDDEN,
                                            key=key)
    models["LSTMAggregation(96, torch_init)"] = lstm_torch_init
    zero_counts()
    t0 = time.perf_counter()
    cards, k8 = {}, {}
    for name, make in models.items():
        before = threefry.KERNEL.launches
        cards[name] = make(device=DEVICE)
        sync()
        k8[name] = threefry.KERNEL.launches - before
    # the launches of the inits alone, before the comparisons' draws
    launches["init_from_key"] = counts()
    say(f"init_from_key: the {len(models)} inits on the card "
        f"{time.perf_counter() - t0:.2f} s")
    for name, make in models.items():
        card, cpu = cards[name], make(device="cpu")
        got, want = card.state_dict(), cpu.state_dict()
        require(sorted(got) == sorted(want), f"{name}: trees differ")
        ulp = max(float_ulps(got[k], want[k]) for k in want)
        equal = sum(int((got[k].cpu() == want[k]).sum()) for k in want)
        total = sum(v.numel() for v in want.values())
        draws = [d for d in card.draws() if d.init != "zeros"]
        uniform_same = all(torch.equal(
            prng.uniform(d.key(key), d.shape, DEVICE, *d.bounds()).cpu(),
            prng.uniform(d.key(key), d.shape, "cpu", *d.bounds()))
            for d in draws)
        top = max((float(d.param.detach().abs().max())
                   / (2.0 / sum(d.shape)) ** 0.5
                   for d in draws if d.init == "xavier"), default=0.0)
        say(f"init_from_key {name}: {total} parameters, bit-equal to the "
            f"CPU's {equal / total:.6f}, at most {ulp} ulp; uniforms bit "
            f"for bit {uniform_same}; largest xavier |w| / sigma "
            f"{top:.4f}; K8 launches {k8[name]}")
        require(uniform_same, f"{name}: the card's uniforms differ")
        require(ulp <= INIT_ULP, f"{name}: {ulp} ulp from the CPU's init")
        require(top <= TRUNC_SIGMAS, f"{name}: a weight at {top} sigma")
        require(k8[name] == len(draws), f"{name}: {k8[name]} K8 launches "
                                        f"for {len(draws)} drawn parameters")
    say(f"init_from_key: {time.perf_counter() - t0:.2f} s [{label}]")


def kernels_vs_plain(g, gsets):
    gen = torch.Generator().manual_seed(1)
    stats = {"threefry_bits": threefry_vs_plain(g)}
    spl, spw, rows, jlo, jhi, a_lo, a_hi = main_batches(g, gen)
    g2 = torch.randn(2, BATCH, HIDDEN, generator=gen).to(DEVICE)
    err1b = k1b_compare(a_lo, g2, f"lo-only M={NUM_WALKS} S'={NUM_STEPS}")
    err1b = max(err1b, k1b_compare(a_hi, g2, f"lead-in-hi M={WIDE_WALKS} "
                                             f"S'={WIDE_STEPS}"))
    a_q4 = q4_inputs(jlo, a_lo[4], a_lo[5], gen)
    g4 = torch.randn(4, a_q4[0].shape[1], HIDDEN, generator=gen).to(DEVICE)
    err1b = max(err1b, k1b_compare(a_q4, g4, "Q=4, lo-only, all-masked set"))
    # wider shapes, from a generator of their own (the later draws stay)
    err1b = max(err1b, k1b_wide(torch.Generator().manual_seed(13)))

    # the attention pool (K3) and its backward
    t_lo = attn_inputs(jlo, a_lo[4], a_lo[5], gen)
    t_hi = attn_inputs(jhi, a_hi[4], a_hi[5], gen)
    stats.update(attn_vs_plain(t_lo, t_hi, g2, gen))
    say(f"phase 2 peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    # the keys-LSTM (K4) and its backward: cases (a)-(g), times at L=301
    # and L=801
    cases, wide = lstm_cases(jlo, jhi, a_lo[4], a_hi[4], a_lo[5], a_hi[5],
                             gen)
    stats["lstm_keys_fwd"] = lstm_vs_plain(cases, wide)
    stats["lstm_keys_bwd"] = lstm_bwd_vs_plain(cases, wide, gen)
    lstm_groups(wide["L=301"], gen)
    del cases, wide
    # the masked LSTM over given rows (K5) and its backward on the table
    # path's input
    cases, wide = table_x_cases(spl, spw, rows, gen)
    stats["lstm_x_fwd"] = lstm_x_vs_plain(cases, wide)
    stats["lstm_x_bwd"] = lstm_x_bwd_vs_plain(cases, wide, gen)
    lstm_x_groups(wide["L=301"], gen)
    del cases, wide

    # the cross lookup of both key words (K6)
    stats["cross_lookup"] = cross_lookup_vs_plain(spl, spw, rows, gsets)
    # the per-slot hidden rows (K7) and their backward
    stats.update(hidden_slots_vs_plain(jlo, jhi, a_lo[4], a_hi[4], a_lo[5],
                                       a_hi[5], spl, rows, gen))

    # the fused key hidden set sum (K1) and the merge (K2)
    stats.update(k1_k2_vs_plain(spl, spw, rows, jlo, a_lo, a_hi))

    # K1 bwd's times
    k1b_ms = time_ms(lambda: k1b_call(
        hidden_sum.fused_key_hidden_sum_bwd_cuda, a_lo, g2))
    k1b_plain = time_ms(lambda: k1b_call(
        hidden_sum.fused_key_hidden_sum_bwd_plain, a_lo, g2), iters=5)
    k1b_hi_ms = time_ms(lambda: k1b_call(
        hidden_sum.fused_key_hidden_sum_bwd_cuda, a_hi, g2))
    say(f"K1 bwd lead-in-hi (L=801) kernel: {k1b_hi_ms:.4f} ms")
    k1b_b = k1b_bound(a_lo, g2)
    say(f"K1 bwd lo-only: kernel {k1b_ms:.4f} ms, bound {k1b_b[0]:.4f} ms "
        f"({k1b_b[1]}), its contraction in two TF32 products at the TF32 "
        f"tensor rate {k1b_tc_ms(a_lo):.4f} ms")
    stats["hidden_sum_bwd"] = dict(
        max_abs_err=err1b, ms=k1b_ms, plain_ms=k1b_plain, library_ms=None,
        bound=k1b_b)
    for name, st in stats.items():
        say(f"{name}: kernel {st['ms']:.4f} ms, plain {st['plain_ms']:.4f} "
            f"ms, library {st['library_ms']}, bound {st['bound'][0]:.4f} ms "
            f"({st['bound'][1]})")
    return stats


# --------------------------------------------------------------- phase 3
def check_sets(spgk: SpGKeys, seeds: torch.Tensor,
               cut: bool = False) -> None:
    """The sampler's invariants (tests/test_sampler.py) on the card. With
    `cut` (a bucket below the visits), a full row may have lost its root
    and some counts to the bucket (it keeps the smallest ids), so the
    root and the walk mass are checked on the other rows."""
    nodes, sizes = spgk.nodes, spgk.sizes.to(torch.int64)
    L = nodes.shape[1]
    valid = torch.arange(L, device=nodes.device)[None, :] < sizes[:, None]
    whole = sizes < L if cut else torch.ones_like(sizes, dtype=torch.bool)
    require(bool((sizes >= 1).all()), "a set without its root")
    require(bool((nodes[~valid] == walk_ops.INT32_MAX).all()),
            "padding is not INT32_MAX")
    require(bool((spgk.klo[~valid] == 0).all()), "padded keys are not 0")
    inc = nodes[:, 1:] > nodes[:, :-1]
    require(bool((inc | ~valid[:, 1:]).all()), "rows are not ascending")
    shift, starts, lead_bit = walk_ops.enc_field_layout(spgk.num_walks,
                                                        spgk.num_steps)
    lo = walk_ops.u32(spgk.klo)
    root = ((lo >> lead_bit) & 1).bool() & valid
    nroots = root.sum(dim=1)
    require(bool(((nroots == 1) | (~whole & (nroots == 0))).all()),
            "not one root per set")
    require(bool((nodes[root] == seeds[nroots == 1]).all()),
            "root is not the seed")
    for j in range(1, spgk.num_steps + 1):
        col = ((lo >> starts[j]) & ((1 << shift) - 1)) * valid
        require(bool((col.sum(dim=1) == spgk.num_walks)[whole].all()),
                f"step {j} does not conserve the walk mass")


def make_net(aggrs: str, device=None, input_dim=NUM_STEPS + 1,
             key=prng.prng_key(0), **kw) -> Net:
    """A Net at the bench width (4 encoding columns, or `input_dim`;
    hidden 96), on the card unless `device` says otherwise, drawn from
    `key` (prng_key(0) unless given)."""
    return Net(input_dim, HIDDEN, aggrs=aggrs, key=key,
               device=DEVICE if device is None else device, **kw)


def in_dim(net) -> int:
    """The input features of a Net's hidden layer."""
    return net.pe_embedding.fc0.in_features


def scalar_sets(sets) -> bool:
    """Whether `sets` is a ScalarSpG's device layout (float values)."""
    return isinstance(sets, SpGDevice) and torch.is_floating_point(
        sets.eidx)


def timed_predict(trainer, edges, label, what):
    """`predict` on one batch (warm), then timed over all of `edges`."""
    trainer.predict(edges[:, :BATCH])
    sync()
    t0 = time.perf_counter()
    scores = trainer.predict(edges)
    sync()
    dt = time.perf_counter() - t0
    n = edges.shape[1]
    require(scores.shape == (n,) and bool(torch.isfinite(scores).all())
            and bool(((scores >= 0) & (scores <= 1)).all()),
            f"predict ({what}) gave bad scores")
    say(f"inference ({what}): {n // BATCH} x {BATCH} queries in {dt:.4f} s "
        f"-> {n / dt:.1f} queries/s [{label}]")


def serve_path(g, label):
    seeds_np = np.arange(g.num_nodes)
    # the cold call on a fresh graph object (`g` has its device arrays
    # cached already): the upload, the first-hop shuffle (seed 0) and the
    # int32 edge tables, each timed, then the walks alone
    fresh = dataclasses.replace(g)
    parts = {}
    for what, fn in (
            ("upload", lambda: device_graph(fresh, DEVICE)),
            ("shuffle", lambda: shuffled_indices_for(fresh, 0, DEVICE)),
            ("tables", lambda: walk_tables_for(fresh, 0, DEVICE)),
            ("walks", lambda: sample_gsets_device_keys(
                fresh, seeds_np, NUM_WALKS, NUM_STEPS, seed=0,
                block_size=SAMPLE_BLOCK, device=DEVICE))):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        parts[what] = time.perf_counter() - t0
    cold = sum(parts.values())
    t0 = time.perf_counter()
    spgk = sample_gsets_device_keys(fresh, seeds_np, NUM_WALKS, NUM_STEPS,
                                    seed=1, shuffle_seed=0,
                                    block_size=SAMPLE_BLOCK, device=DEVICE)
    sync()
    warm = time.perf_counter() - t0
    del fresh
    say(f"sampling: {g.num_nodes} sets, L={spgk.nodes.shape[1]}, cold "
        f"{cold:.3f} s on a fresh graph object (upload "
        f"{parts['upload']:.4f} s, shuffle {parts['shuffle']:.4f} s, int32 "
        f"tables {parts['tables']:.4f} s, the walks {parts['walks']:.4f} "
        f"s), warm {warm:.3f} s -> {g.num_nodes / warm:.1f} sets/s "
        f"[{label}]")
    check_sets(spgk, torch.arange(g.num_nodes, device=DEVICE))

    net = make_net("mean", dropout=0.1, dtype="bfloat16",
                   key=prng.prng_key(0))
    trainer = trainer_from_keys(net, spgk, TrainConfig(batch_size=BATCH))
    rng = np.random.default_rng(0)
    edges = torch.as_tensor(rng.integers(
        0, g.num_nodes, size=(2, N_BATCHES * BATCH))).to(DEVICE)
    timed_predict(trainer, edges, label, "mean")

    gen = torch.Generator(device=DEVICE).manual_seed(7)
    src = torch.randint(0, g.num_nodes, (N_SRC,), generator=gen,
                        device=DEVICE)
    dst = torch.randint(0, g.num_nodes, (N_SRC,), generator=gen,
                        device=DEVICE)
    sync()
    t0 = time.perf_counter()
    pos = trainer.predict(torch.stack([src, dst]))
    ns = src.repeat_interleave(K_NEG)
    nd = torch.randint(0, g.num_nodes, ns.shape, generator=gen,
                       device=DEVICE)
    neg = trainer.predict(torch.stack([ns, nd])).reshape(N_SRC, K_NEG)
    mrr = float(device_mrr(pos, neg))
    dt = time.perf_counter() - t0
    pairs = N_SRC * (K_NEG + 1)
    require(math.isfinite(mrr) and 0 < mrr <= 1, f"MRR {mrr} out of range")
    say(f"mrr eval: {N_SRC} sources x {K_NEG} negatives, {pairs} pairs in "
        f"{dt:.4f} s -> {pairs / dt:.1f} pairs/s, MRR={mrr:.6f} [{label}]")
    return spgk, net, edges


def trainer_for(net, sets, cfg, join_factory=None):
    """The trainer of `net` over any store of sets: a table (or, over a
    ScalarSpG's values, a scalar) DeviceTrainer over an SpGDevice,
    `trainer_from_keys` over an SpGKeys (with `join_factory`, if given)."""
    if isinstance(sets, SpGDevice):
        return DeviceTrainer(net, sets, cfg, join=(
            gather_join_scalar if scalar_sets(sets) else None))
    return trainer_from_keys(net, sets, cfg, join_factory=join_factory)


def pair_join(num_walks, num_steps):
    """The keys join with the unpacked feature pairs: the unfused route
    reads them through the hidden layer (the JAX package's XLA route)
    instead of forming the hidden rows from the keys (K7)."""
    return make_keys_join(num_walks, num_steps, aligned=True, features=True)


def path_name(trainer) -> str:
    """The aggregator (or HONet), which store the trainer reads, and the
    unfused route where the model takes it."""
    store = ""
    if isinstance(trainer.sets, SpGDevice):
        store = ", scalar" if scalar_sets(trainer.sets) else ", table"
    unfused = trainer.model.fused_hidden is False
    return (f"{getattr(trainer.model, 'aggrs', 'honet')}"
            f"{store}{', unfused' if unfused else ''}")


def subset(sets, edges: torch.Tensor):
    """The rows of the sets that `edges` [2, n] name, on the card and on
    the CPU, and the edges renumbered to them."""
    rows = torch.unique(edges)
    remap = torch.searchsorted(rows, edges.contiguous())
    if isinstance(sets, SpGDevice):
        small = SpGDevice(nodes=sets.nodes[rows], eidx=sets.eidx[rows],
                          sizes=sets.sizes[rows], enc=sets.enc)
        cpu_small = SpGDevice(*(t.cpu() for t in (
            small.nodes, small.eidx, small.sizes, small.enc)))
        return small, cpu_small, remap
    small = SpGKeys(nodes=sets.nodes[rows], khi=sets.khi[rows],
                    klo=sets.klo[rows], sizes=sets.sizes[rows],
                    num_walks=sets.num_walks, num_steps=sets.num_steps)
    cpu_small = SpGKeys(*(t.cpu() for t in (small.nodes, small.khi,
                                            small.klo, small.sizes)),
                        num_walks=small.num_walks,
                        num_steps=small.num_steps)
    return small, cpu_small, remap


def check_routes(spgk, net, edges) -> None:
    """The fused route against the plain route (the hidden layer over the
    feature pairs) on one batch (both on the card), and the card against
    the port's CPU path on a few queries."""
    aggrs, state = net.aggrs, net.state_dict()
    be = edges[:, :BATCH]
    plain = make_net(aggrs, dropout=0.1, dtype="bfloat16",
                     fused_hidden=False)
    plain.load_state_dict(state)
    rows_be = (spgk.nodes, spgk.khi, spgk.klo, spgk.sizes, be)
    with torch.inference_mode():
        got = net.eval()(make_keys_join(
            NUM_WALKS, NUM_STEPS, **net.join_outputs(DEVICE))(*rows_be))
        want = plain.eval()(pair_join(NUM_WALKS, NUM_STEPS)(*rows_be))
    require(got.shape == (BATCH,) and bool(torch.isfinite(got).all()),
            f"fused route ({aggrs}) gave bad logits")
    err = float((got - want).abs().max())
    say(f"fused vs plain route ({aggrs}), one batch of {BATCH} (bf16): max "
        f"|d logit| = {err:.3e}, max |logit| = {float(want.abs().max()):.3e}"
        f" (rtol = atol = {ROUTE_TOL})")
    require(torch.allclose(got, want, rtol=ROUTE_TOL, atol=ROUTE_TOL),
            f"fused route ({aggrs}) disagrees with the plain route")

    small, cpu_small, remap = subset(spgk, be[:, :N_REF])
    cfg = TrainConfig(batch_size=N_REF)
    f32_gpu = make_net(aggrs, dropout=0.1)
    f32_gpu.load_state_dict(state)
    f32_cpu = make_net(aggrs, dropout=0.1, device="cpu")
    f32_cpu.load_state_dict(state)
    got = trainer_from_keys(f32_gpu, small, cfg).predict(remap)
    want = trainer_from_keys(f32_cpu, cpu_small, cfg).predict(remap.cpu())
    err = float((got.cpu() - want).abs().max())
    say(f"card vs CPU path ({aggrs}), {N_REF} queries (fp32): max |d score|"
        f" = {err:.3e} (rtol = atol = {CPU_TOL})")
    require(torch.allclose(got.cpu(), want, rtol=CPU_TOL, atol=CPU_TOL),
            "the card disagrees with the port's CPU path")


def profile(run, steps: int, what: str) -> None:
    """Where `run` (`steps` steps of `what`) spends its device time:
    torch.profiler over one call after a warm call, kernels summed by
    name, and the device's busy share of the window's wall time (kernel
    time over wall time; the kernels run on one stream)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    run()
    sync()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        # kernels only: a record_function range (the optimizer's step)
        # also shows on the device, around the kernels it contains
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            by_name[e.name][0] += e.time_range.elapsed_us()
            by_name[e.name][1] += 1
    busy_us = sum(t for t, _ in by_name.values())
    launched = sum(n for _, n in by_name.values())
    say(f"profile: {steps} {what}, wall {wall_us / 1e3:.3f} ms, kernel "
        f"time {busy_us / 1e3:.3f} ms (device time a step "
        f"{busy_us / steps / 1e3:.4f} ms, device busy "
        f"{100 * busy_us / wall_us:.1f}%), {launched / steps:.1f} kernel "
        f"launches per step in {len(by_name)} kernel names")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for i, (name, (t, n)) in enumerate(ranked):
        if i < 14 or LISTED_KERNELS.search(name):
            say(f"  {t / steps / 1e3:.4f} ms/step  x{n // steps:<3d} "
                f"{name[:100]}")


def profile_predict(sets, net, edges, batches: int = 8) -> None:
    trainer = trainer_for(net, sets, TrainConfig(batch_size=BATCH))
    be = edges[:, :batches * BATCH]
    profile(lambda: trainer.predict(be), batches,
            f"predict batches ({path_name(trainer)})")


def train_setup(sets, aggrs: str, fused_hidden=None):
    """bench.py:153-165 (and :206-212 for attn and lstm) on the port: the
    bench Net of `aggrs` (on the route `fused_hidden` picks) from a seeded
    generator, its trainer over `sets` (SpGKeys or SpGDevice), 32 x 4096
    random query edges with random 0/1 labels, and the key of the
    permutations and dropout masks."""
    net = make_net(aggrs, dropout=0.1, dtype="bfloat16",
                   fused_hidden=fused_hidden,
                   input_dim=1 if scalar_sets(sets) else NUM_STEPS + 1,
                   key=prng.prng_key(0))
    trainer = trainer_for(net, sets, TrainConfig(
        batch_size=BATCH, lr=LR, grad_clip=GRAD_CLIP))
    rng = np.random.default_rng(0)
    n = N_BATCHES * BATCH
    edges = torch.as_tensor(rng.integers(
        0, sets.nodes.shape[0], size=(2, n))).to(DEVICE)
    labels = torch.as_tensor((rng.random(n) < 0.5).astype(
        np.float32)).to(DEVICE)
    return trainer, edges, labels, prng.prng_key(1)


def fit_cold(trainer, edges, labels, key, epochs) -> None:
    """The first fit, under CUDA's sync debug mode: the epoch loop must
    never wait for the device (the losses and AUCs stay on it)."""
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            losses, _ = trainer.fit(edges, labels, epochs, key)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = collections.Counter(
        str(w.message) for w in caught
        if "synchronizing" in str(w.message)
        and "prototype" not in str(w.message))
    last = float(losses[-1])
    say(f"fit cold ({path_name(trainer)}): {epochs} epochs, last loss "
        f"{last:.6f}, "
        f"{time.perf_counter() - t0:.3f} s; {sum(syncs.values())} "
        f"synchronizing calls inside the fit {dict(syncs)}")
    require(not syncs, "the fit waits for the device")


def fit_timed(trainer, edges, labels, key, epochs, label) -> None:
    """The timed fit (bench.py:178-186, :218-224), with its checks."""
    start = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    sync()
    t0 = time.perf_counter()
    losses, aucs = trainer.fit(edges, labels, epochs, key)
    sync()
    dt = time.perf_counter() - t0
    losses, aucs = losses.cpu(), aucs.cpu()
    n = epochs * edges.shape[1]
    steps = epochs * -(-edges.shape[1] // trainer.config.batch_size)
    say(f"train ({path_name(trainer)}): {epochs} epochs x {edges.shape[1]}"
        f" queries in {dt:.4f} s -> {n / dt:.1f} queries/s "
        f"({steps} steps, {1e3 * dt / steps:.4f} ms/step) [{label}]")
    say(f"  epoch losses {[round(float(x), 6) for x in losses]}")
    say(f"  epoch AUCs   {[round(float(x), 6) for x in aucs]}")
    require(bool(torch.isfinite(losses).all()), "a loss is not finite")
    require(bool(((aucs >= 0) & (aucs <= 1)).all()), "an AUC is not in "
            "[0, 1]")
    still = [k for k, v in trainer.model.state_dict().items()
             if torch.equal(v, start[k])]
    require(not still, f"parameters did not move: {still}")


def route_grads(sets, net, be, dtype, fused, labels=None, cot=None,
                pairs=True, weights=None, seen=None):
    """(loss, {name: gradient}) of one batch `be` on one route of a copy
    of `net` over `sets` (SpGKeys or SpGDevice), joined and fed as its
    trainer does, with a fixed dropout mask: of the BCE loss with
    `labels` (each query weighted by `weights`, or 1), or, with `cot`
    [B, 2 H], of sum(cot * the scorer's input), which leaves the scorer
    (MergeLayer) out of the gradient. The unfused route over SpGKeys
    reads the feature pairs, or with `pairs` False the aligned keys (K7).
    A list `seen` receives the scorer's first-layer pre-activations
    [B, H] and the logits [B], in float32."""
    m = make_net(net.aggrs, dropout=0.1, dtype=dtype, fused_hidden=fused,
                 input_dim=in_dim(net))
    m.load_state_dict(net.state_dict())
    keys_pairs = not fused and pairs and isinstance(sets, SpGKeys)
    trainer = trainer_for(m, sets, TrainConfig(batch_size=BATCH),
                          join_factory=pair_join if keys_pairs else None)
    joined, _ = trainer._batch(be)
    inputs = []
    hook = m.affinity_score.register_forward_pre_hook(
        lambda mod, args: inputs.append(torch.cat(args[0], dim=-1)))
    logits = m.train()(joined, key=prng.prng_key(3), **trainer.train_kw)
    hook.remove()
    if seen is not None:
        fc0 = m.affinity_score.fc0
        with torch.no_grad():
            seen.append((torch.nn.functional.linear(
                inputs[0].to(m.dtype), fc0.weight.to(m.dtype),
                fc0.bias.to(m.dtype)).float(), logits.detach().float()))
    if cot is None:
        loss = batch_loss(logits, labels, torch.ones(
            be.shape[1], device=DEVICE) if weights is None else weights)
    else:
        loss = (inputs[0] * cot).sum() / be.shape[1]
    loss.backward()
    return float(loss.detach()), {k: p.grad for k, p in m.named_parameters()
                                  if p.grad is not None}


def held_route_grads(sets, net, be, dtype, labels, pairs=True):
    """The fused and the plain route's (loss, gradients) in `dtype` with
    `labels`, as `route_grads`, less the queries whose scorer relu
    decisions the two routes part (weight 0 in both routes). A query's
    gradient carries a decision's whole term, so one parted decision
    moves a gradient that the labels cancel, or a unit whose
    pre-activations crowd 0, by percents: flax's weights from prng_key(0)
    on an H100 (`results/torch_h100/init_flip_probe.py`): the lstm Net's
    fp32 routes part one decision, at 6.5e-11 against 0.111 at most, and
    it moves the scorer's bias gradient by 1.3% (3.6e-6 without it); the
    mean Net's bf16 routes part 14% of one unit's decisions and move its
    all-one-labels gradient by 22% (`init_route_probe.py`). Required, so
    that a fault cannot hide among those queries: every parted
    pre-activation within PARTED_BAND[dtype] of the largest |pre| of 0
    on both routes, those queries' logits within the same share (the
    routes' logits limit) of each other, and at most
    PARTED_QUERIES[dtype] of them. `results/torch_h100/
    init_parted_probe.py` runs this at keys 0-3."""
    seen = []
    runs = [route_grads(sets, net, be, dtype, fused, labels=labels,
                        pairs=pairs, seen=seen) for fused in (True, False)]
    (pf, lf), (pp, lp) = seen
    part = (pf > 0) != (pp > 0)
    queries = part.any(dim=1)
    n, tol = int(queries.sum()), PARTED_BAND[dtype]
    top = float(torch.maximum(pf.abs().max(), pp.abs().max()))
    worst = float(torch.maximum(pf[part].abs().max(), pp[part].abs().max())
                  ) if n else 0.0
    logits = float((lf[queries] - lp[queries]).abs().max()) if n else 0.0
    ok = (worst <= tol * top and n <= PARTED_QUERIES[dtype]
          and torch.allclose(lf[queries], lp[queries], rtol=tol, atol=tol))
    say(f"the {dtype} routes ({net.aggrs}) part {int(part.sum())} of the "
        f"scorer's relu decisions, in {n} queries (at most "
        f"{PARTED_QUERIES[dtype]}); largest parted |pre-activation| "
        f"{worst:.3e} against {top:.3e} at most (band {tol}); those "
        f"queries' logits apart by {logits:.3e} at most (rtol = atol = "
        f"{tol}) {'ok' if ok else 'FAIL'}")
    require(ok, f"the {dtype} routes ({net.aggrs}) part the scorer's relu "
                f"decisions beyond rounding ({n} queries)")
    if not n:
        return runs
    keep = (~queries).float()
    return [route_grads(sets, net, be, dtype, fused, labels=labels,
                        pairs=pairs, weights=keep) for fused in (True, False)]


def rel_err(x, y) -> float:
    return float((x - y).abs().max() / y.abs().max())


def compare_grads(what, net, pair, tol, held=True):
    """Print, and unless `held` is False require, each gradient's largest
    fused - plain difference within `tol` of its largest entry. The
    attention gate's bias is held to GATE_BIAS_GRAD_ATOL instead."""
    (lf, gf), (lp, gp) = pair
    rels, bias_err = {}, 0.0
    for k, want in gp.items():
        require(bool(torch.isfinite(gf[k]).all()), f"grad {k} not finite")
        if k == GATE_BIAS:
            bias_err = float((gf[k] - want).abs().max())
        else:
            rels[k] = rel_err(gf[k], want)
    worst = max(rels.values())
    ok = worst <= tol and bias_err <= GATE_BIAS_GRAD_ATOL
    gate = ""
    if GATE_BIAS in gp:
        gate = (f"; {GATE_BIAS} {float(gf[GATE_BIAS]):.3e} vs "
                f"{float(gp[GATE_BIAS]):.3e}, |diff| {bias_err:.3e} (atol "
                f"{GATE_BIAS_GRAD_ATOL})")
    verdict = ("ok" if ok else "FAIL") if held else "printed, not held"
    say(f"fused vs plain route gradients ({net.aggrs}), one batch of "
        f"{BATCH}, {what}: loss {lf:.6f} vs {lp:.6f}; max|fused - plain| / "
        f"max|plain| by tensor "
        f"{ {k: float(f'{v:.3e}') for k, v in rels.items()} }, worst "
        f"{worst:.3e} (tol {tol}){gate} {verdict}")
    require(ok or not held, f"fused route gradients ({net.aggrs}, {what}) "
            "disagree with the plain route's")


def check_train_routes(sets, net, edges, labels) -> None:
    """One bench batch's parameter gradients at the seeded initial
    weights: the fused route (the kernels forward and backward) against
    the plain route, with the same dropout mask. Each tensor's largest
    difference is held to a share of its largest gradient
    (GRAD_ROUTE_TOL).

    float32 uses the batch's random labels. With random labels the
    gradient is a sum of per-query terms of either sign that nearly
    cancel, and the two bf16 routes round the logits apart by about
    1e-3, systematically, which is no longer small against that sum; so
    bfloat16 uses labels of all ones, a cotangent that does not cancel
    across the batch. Both leave out the queries whose scorer relu
    decisions the two routes part (`held_route_grads` says why and
    bounds them): in bf16 they part where a unit's pre-activations crowd
    0, and at flax's initial weights the mean Net's bf16 plain route then
    lies further from the float32 gradient than the fused one does (both
    distances are printed, over every query). What is also held in bf16
    for every aggregator is the gradient of a fixed random cotangent on
    the scorer's input: every parameter upstream of the scorer, through
    the kernels, without the scorer's relus.

    The attention gate's bias has a gradient of 0 up to rounding (a shift
    of every gate of a set leaves the softmax as it is): a share of its
    largest entry would divide noise by noise, so it is held to
    GATE_BIAS_GRAD_ATOL instead."""
    be = edges[:, :BATCH]
    ones = torch.ones(BATCH, device=DEVICE)
    tol32, tol16 = GRAD_ROUTE_TOL["float32"], GRAD_ROUTE_TOL["bfloat16"]
    compare_grads("float32, random labels", net, held_route_grads(
        sets, net, be, "float32", labels[:BATCH]), tol32)
    compare_grads("bfloat16, all-one labels", net, held_route_grads(
        sets, net, be, "bfloat16", ones), tol16)
    ref = route_grads(sets, net, be, "float32", False, labels=ones)[1]
    dist = {}
    for fused in (True, False):
        got = route_grads(sets, net, be, "bfloat16", fused, labels=ones)[1]
        for k in ref:
            if k != GATE_BIAS:
                dist.setdefault(k, []).append(
                    float(f"{rel_err(got[k], ref[k]):.2e}"))
    say(f"  every query's bf16 distance to the fp32 plain gradient "
        f"(fused, plain): { {k: tuple(v) for k, v in dist.items()} }")
    cot = torch.randn(BATCH, 2 * HIDDEN,
                      generator=torch.Generator().manual_seed(5)).to(DEVICE)
    compare_grads("bfloat16, random cotangent on the scorer's input", net,
                  [route_grads(sets, net, be, "bfloat16", fused, cot=cot)
                   for fused in (True, False)], tol16)


def check_train_cpu(sets, net, edges, labels, fused_hidden=None) -> None:
    """A few training steps on the card (the fused route, or the route
    `fused_hidden` picks; kernels) against the port's CPU path (unfused
    route, feature pairs), fp32, dropout 0, one shared permutation, over
    `sets` (SpGKeys or SpGDevice). The attention gate's bias is held to
    GATE_BIAS_FIT_ATOL: Adam turns its noise gradient into steps of up to
    about lr."""
    n = REF_STEPS * REF_BATCH
    small, cpu_small, remap = subset(sets, edges[:, :n])
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(4))
    cfg = TrainConfig(batch_size=REF_BATCH, lr=LR, grad_clip=GRAD_CLIP)
    out = {}
    for dev, part in ((DEVICE, small), ("cpu", cpu_small)):
        m = make_net(net.aggrs, dropout=0.0, device=dev,
                     fused_hidden=fused_hidden, input_dim=in_dim(net))
        m.load_state_dict(net.state_dict())
        trainer = trainer_for(m, part, cfg)
        losses, _ = trainer.fit(
            remap.to(dev), labels[:n].to(dev), 1, prng.prng_key(0),
            perms=[perm.reshape(REF_STEPS, REF_BATCH)])
        out[dev] = (losses.cpu(), {k: v.cpu() for k, v in
                                   m.state_dict().items()})
    (lg, pg), (lc, pc) = out[DEVICE], out["cpu"]
    err = max(float((pg[k] - pc[k]).abs().max()) for k in pc
              if k != GATE_BIAS)
    ok = all(torch.allclose(pg[k], pc[k], rtol=CPU_TRAIN_RTOL, atol=(
        GATE_BIAS_FIT_ATOL if k == GATE_BIAS else CPU_TRAIN_ATOL))
        for k in pc)
    gate = ""
    if GATE_BIAS in pc:
        gate = (f", {GATE_BIAS} |d| "
                f"{float((pg[GATE_BIAS] - pc[GATE_BIAS]).abs().max()):.3e} "
                f"(atol {GATE_BIAS_FIT_ATOL})")
    say(f"card vs CPU training ({path_name(trainer)}), {REF_STEPS} steps x "
        f"{REF_BATCH} queries (fp32): loss {float(lg[0]):.6f} vs "
        f"{float(lc[0]):.6f}, max |d param| = {err:.3e} (rtol "
        f"{CPU_TRAIN_RTOL}, atol {CPU_TRAIN_ATOL}){gate} "
        f"{'ok' if ok else 'FAIL'}")
    require(ok and torch.allclose(lg, lc, rtol=1e-5),
            "training on the card disagrees with the port's CPU path")


def lstm_serve(trainer, edges, label) -> None:
    """The LSTM serving path (bench.py:207-209, :225-231) on the port: a
    cold predict over `edges` with the bench Net, then a timed one."""
    sync()
    t0 = time.perf_counter()
    trainer.predict(edges)
    sync()
    dt = time.perf_counter() - t0
    say(f"inference cold ({path_name(trainer)}): {edges.shape[1] // BATCH} "
        f"x {BATCH} queries in {dt:.4f} s [{label}]")
    timed_predict(trainer, edges, label, path_name(trainer))


def profile_train(trainer, edges, labels, key, steps: int = 8) -> None:
    be, bl = edges[:, :steps * BATCH], labels[:steps * BATCH]
    profile(lambda: trainer.train_epoch(be, bl, key), steps,
            f"train steps ({path_name(trainer)})")


def table_sets(g, spgk: SpGKeys, label) -> SpGDevice:
    """`sample_gsets_device` at the bench width: cold (a fresh row shuffle
    and walk tables), then warm with the keys sampler's seeds, whose sets
    must be the keys sampler's `spgk`: the same nodes and sizes, and each
    valid slot's table row its key unpacked, exactly."""
    seeds_np = np.arange(g.num_nodes)
    kw = dict(block_size=SAMPLE_BLOCK, device=DEVICE)
    sync()
    t0 = time.perf_counter()
    sample_gsets_device(g, seeds_np, NUM_WALKS, NUM_STEPS, seed=2, **kw)
    sync()
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev, u = sample_gsets_device(g, seeds_np, NUM_WALKS, NUM_STEPS, seed=1,
                                 shuffle_seed=0, **kw)
    sync()
    warm = time.perf_counter() - t0
    n = g.num_nodes
    say(f"table sampling: {n} sets, L={dev.nodes.shape[1]}, u={u} unique "
        f"encodings, table width {dev.enc.shape[0] - 1}; cold {cold:.3f} s "
        f"(shuffle + tables) -> {n / cold:.1f} sets/s, warm {warm:.3f} s "
        f"-> {n / warm:.1f} sets/s [{label}]")
    require(torch.equal(dev.nodes, spgk.nodes)
            and torch.equal(dev.sizes, spgk.sizes),
            "the table sampler's sets differ from the keys sampler's")
    valid = (torch.arange(dev.nodes.shape[1], device=DEVICE)[None, :]
             < dev.sizes[:, None].to(torch.int64))
    rows = dev.enc[dev.eidx][valid]
    keys = unpack_key_features(spgk.khi, spgk.klo, NUM_WALKS,
                               NUM_STEPS)[valid]
    require(torch.equal(rows, keys), "a table row is not its slot's key")
    require(bool((dev.eidx[~valid] == 0).all()), "a padded slot indexes "
            "a table row")
    say(f"table sets: nodes and sizes equal the keys sampler's; enc[eidx] "
        f"equals the unpacked keys on all {rows.shape[0]} valid slots")
    return dev


def check_table_routes(dev: SpGDevice, spgk: SpGKeys, net, edges) -> None:
    """The table Net's fused route against its unfused route on one batch
    (bf16, both on the card); its scores against the keys path's with the
    same weights on N_REF queries (fp32, both on the card: the same
    function by two routes); and the card against the port's CPU path on
    those queries (fp32)."""
    aggrs, state = net.aggrs, net.state_dict()
    be = edges[:, :BATCH]
    plain = make_net(aggrs, dropout=0.1, dtype="bfloat16",
                     fused_hidden=False)
    plain.load_state_dict(state)
    joined = gather_join(dev.nodes, dev.eidx, dev.sizes, be)
    with torch.inference_mode():
        got = net.eval()(joined, enc_table=dev.enc)
        want = plain.eval()(joined, enc_table=dev.enc)
    require(got.shape == (BATCH,) and bool(torch.isfinite(got).all()),
            f"table fused route ({aggrs}) gave bad logits")
    err = float((got - want).abs().max())
    say(f"table fused vs plain route ({aggrs}), one batch of {BATCH} "
        f"(bf16): max |d logit| = {err:.3e}, max |logit| = "
        f"{float(want.abs().max()):.3e} (rtol = atol = {ROUTE_TOL})")
    require(torch.allclose(got, want, rtol=ROUTE_TOL, atol=ROUTE_TOL),
            f"table fused route ({aggrs}) disagrees with the plain route")

    q = be[:, :N_REF]
    cfg = TrainConfig(batch_size=N_REF)
    f32 = lambda device=None: make_net(aggrs, dropout=0.1, device=device)
    table_net, keys_net, cpu_net = f32(), f32(), f32("cpu")
    for m in (table_net, keys_net, cpu_net):
        m.load_state_dict(state)
    got = DeviceTrainer(table_net, dev, cfg).predict(q)
    want = trainer_from_keys(keys_net, spgk, cfg).predict(q)
    err = float((got - want).abs().max())
    say(f"table vs keys path ({aggrs}), {N_REF} queries (fp32): max "
        f"|d score| = {err:.3e} (rtol = atol = {CPU_TOL})")
    require(torch.allclose(got, want, rtol=CPU_TOL, atol=CPU_TOL),
            f"the table path ({aggrs}) disagrees with the keys path")
    small, cpu_small, remap = subset(dev, q)
    got = DeviceTrainer(table_net, small, cfg).predict(remap)
    want = DeviceTrainer(cpu_net, cpu_small, cfg).predict(remap.cpu())
    err = float((got.cpu() - want).abs().max())
    say(f"card vs CPU path ({aggrs}, table), {N_REF} queries (fp32): max "
        f"|d score| = {err:.3e} (rtol = atol = {CPU_TOL})")
    require(torch.allclose(got.cpu(), want, rtol=CPU_TOL, atol=CPU_TOL),
            "the card disagrees with the port's CPU path (table)")


def table_path(g, spgk: SpGKeys, edges, labels, label,
               launches) -> SpGDevice:
    """The encoding-table path on the keys path's graph, sets and edges:
    sampling, serving (mean, attn; lstm on K5) and training (mean, attn;
    lstm on K5 and K5 bwd), with their checks; the launch counts go into
    `launches`. Returns the table sets."""
    dev = table_sets(g, spgk, label)
    nets = {a: make_net(a, dropout=0.1, dtype="bfloat16",
                        key=prng.prng_key(0))
            for a in ("mean", "attn", "lstm")}
    serve = {a: DeviceTrainer(n, dev, TrainConfig(batch_size=BATCH))
             for a, n in nets.items()}
    zero_counts()
    for a in ("mean", "attn"):
        timed_predict(serve[a], edges, label, f"{a}, table")
    launches["table_serve"] = counts()
    say(f"launches on the table serving path (mean, attn): "
        f"{launches['table_serve']}")
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    lstm_serve(serve["lstm"], edges, label)
    launches["table_lstm_serve"] = counts()
    say(f"launches on the table LSTM serving path: "
        f"{launches['table_lstm_serve']}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for net in nets.values():
        check_table_routes(dev, spgk, net, edges)
    profile_predict(dev, nets["lstm"], edges)
    paths = {"mean": ("table_train", N_EPOCHS),
             "attn": ("table_attn_train", ATTN_EPOCHS),
             "lstm": ("table_lstm_train", LSTM_EPOCHS)}
    for aggrs, (path, epochs) in paths.items():
        trainer, _, _, key = train_setup(dev, aggrs)
        if aggrs == "lstm":
            check_train_routes(dev, trainer.model, edges, labels)
        fit_cold(trainer, edges, labels, key, epochs)
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        fit_timed(trainer, edges, labels, key, epochs, label)
        launches[path] = counts()
        say(f"launches on the table training path ({aggrs}, timed fit): "
            f"{launches[path]}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        check_train_cpu(dev, trainer.model, edges, labels)
        profile_train(trainer, edges, labels, key)
    return dev


def keys_pallas_path(spgk: SpGKeys, edges, label, launches, gsets) -> None:
    """The keys join's impl "pallas" (K6) on the bench sets: mean and lstm
    `predict` through `trainer_from_keys(..., join_factory=...)` (the
    fused Net over a join without key planes: masked_mean, K5), the
    feature pairs against the merge join's exactly, the scores against
    the keys route's (fp32 at CPU_TOL, bf16 at ROUTE_TOL); then one
    predict in the general hi/lo layout (`general_sets`), whose pallas
    and merge joins must be equal."""
    pallas = lambda m, s: make_keys_join(m, s, impl="pallas")
    cfg = TrainConfig(batch_size=BATCH)
    nets = {a: make_net(a, dropout=0.1, dtype="bfloat16",
                        key=prng.prng_key(0))
            for a in ("mean", "lstm")}
    serve = {a: trainer_from_keys(n, spgk, cfg, join_factory=pallas)
             for a, n in nets.items()}
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    for a, trainer in serve.items():
        timed_predict(trainer, edges, label, f"{a}, pallas join")
    launches["keys_pallas_serve"] = counts()
    say(f"launches on the pallas-join serving path (mean, lstm): "
        f"{launches['keys_pallas_serve']}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    be = edges[:, :BATCH]
    rows = (spgk.nodes, spgk.khi, spgk.klo, spgk.sizes, be)
    jp = pallas(NUM_WALKS, NUM_STEPS)(*rows)
    jm = make_keys_join(NUM_WALKS, NUM_STEPS)(*rows)
    same = torch.equal(jp.eidx, jm.eidx) and torch.equal(jp.mask, jm.mask)
    say(f"pallas vs merge join, one batch of {BATCH}: feature pairs and "
        f"masks equal: {same}")
    require(same, "the pallas join differs from the merge join")
    for a, net in nets.items():
        for dtype, tol in (("float32", CPU_TOL), ("bfloat16", ROUTE_TOL)):
            pn, kn = (make_net(a, dropout=0.1, dtype=dtype)
                      for _ in range(2))
            pn.load_state_dict(net.state_dict())
            kn.load_state_dict(net.state_dict())
            got = trainer_from_keys(pn, spgk, cfg,
                                    join_factory=pallas).predict(be)
            want = trainer_from_keys(kn, spgk, cfg).predict(be)
            err = float((got - want).abs().max())
            say(f"pallas join vs keys route ({a}, {dtype}), {BATCH} "
                f"queries: max |d score| = {err:.3e} (rtol = atol = {tol})")
            require(torch.allclose(got, want, rtol=tol, atol=tol),
                    f"the pallas-join route ({a}, {dtype}) disagrees with "
                    "the keys route")

    gspgk, grows = gsets
    grow_args = (gspgk.nodes, gspgk.khi, gspgk.klo, gspgk.sizes, grows)
    jp = pallas(GEN_WALKS, GEN_STEPS)(*grow_args)
    jm = make_keys_join(GEN_WALKS, GEN_STEPS)(*grow_args)
    same = (jp.kown is None and jm.kown is None
            and torch.equal(jp.eidx, jm.eidx)
            and torch.equal(jp.mask, jm.mask))
    gnet = Net(GEN_STEPS + 1, HIDDEN, aggrs="lstm", dropout=0.1,
               dtype="bfloat16", key=prng.prng_key(0),
               device=DEVICE)
    n = grows.shape[1]
    gtrainer = trainer_from_keys(gnet, gspgk, TrainConfig(batch_size=n),
                                 join_factory=pallas)
    sync()
    t0 = time.perf_counter()
    scores = gtrainer.predict(grows)
    sync()
    dt = time.perf_counter() - t0
    ok = (scores.shape == (n,) and bool(torch.isfinite(scores).all())
          and bool(((scores >= 0) & (scores <= 1)).all()))
    say(f"general layout M={GEN_WALKS} S'={GEN_STEPS}, {n} queries "
        f"(L={gspgk.nodes.shape[1]}): pallas and merge joins equal: {same}; "
        f"lstm predict through the pallas join {dt:.4f} s, scores finite "
        f"in [0, 1]: {ok} [{label}]")
    require(same, "the general layout's pallas and merge joins differ")
    require(ok, "predict in the general layout gave bad scores")


def wide_lstm_fits(spw: SpGKeys, gsets, label) -> None:
    """The lstm Net trains on wide sets: a short fit at M=200, S'=4 (L=801,
    the keys route: K4 and K4 bwd, the stash whole) and a few steps in the
    general hi/lo layout (M=1000, S'=4, L=4001, batch 4096: the route over
    feature pairs, K5 and K5 bwd, the stash in row groups), each with its
    peak device memory and the rows of a stash group."""
    cap = torch.cuda.get_device_properties(0).total_memory
    for what, sets, nsteps, steps in (
            (f"lead-in-hi M={WIDE_WALKS} S'={WIDE_STEPS}", spw, WIDE_STEPS,
             4),
            (f"general M={GEN_WALKS} S'={GEN_STEPS}", gsets[0], GEN_STEPS,
             2)):
        net = Net(nsteps + 1, HIDDEN, aggrs="lstm", dropout=0.1,
                  dtype="bfloat16", key=prng.prng_key(0),
                  device=DEVICE)
        trainer = trainer_from_keys(net, sets, TrainConfig(
            batch_size=BATCH, lr=LR, grad_clip=GRAD_CLIP))
        rng = np.random.default_rng(3)
        n = steps * BATCH
        edges = torch.as_tensor(rng.integers(
            0, sets.nodes.shape[0], size=(2, n))).to(DEVICE)
        labels = torch.as_tensor((rng.random(n) < 0.5).astype(
            np.float32)).to(DEVICE)
        key = prng.prng_key(1)
        ell = sets.nodes.shape[1]
        rows = 2 * BATCH
        group = lstm_keys.stash_group(rows, ell, HIDDEN)
        stash_gb = 4 * lstm_keys.bwd_layout(rows, ell, 1, HIDDEN,
                                            None)["stash"] / 1e9
        start = {k: v.clone() for k, v in net.state_dict().items()}
        torch.cuda.empty_cache()
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        sync()
        t0 = time.perf_counter()
        losses, _ = trainer.fit(edges, labels, 1, key)
        sync()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        still = [k for k, v in net.state_dict().items()
                 if torch.equal(v, start[k])]
        lstm_counts = {k: v for k, v in counts().items() if "lstm" in k}
        say(f"wide lstm fit ({what}, L={ell}): {steps} steps of {BATCH} "
            f"queries in {dt:.3f} s, loss {float(losses[-1]):.6f}; the "
            f"whole stash would be {stash_gb:.1f} GB: {group} rows a stash "
            f"group ({-(-rows // group)} groups of {rows} rows); peak device "
            f"memory {peak / 2**30:.2f} GiB of {cap / 2**30:.2f}; launches "
            f"{lstm_counts} [{label}]")
        require(bool(torch.isfinite(losses).all()), f"wide fit ({what}): a "
                "loss is not finite")
        require(not still, f"wide fit ({what}): parameters did not move: "
                f"{still}")
        require(peak < cap, f"wide fit ({what}): peak memory past the card")
        del net, trainer, edges, labels, start
    torch.cuda.empty_cache()


def check_unfused_routes(spgk: SpGKeys, net, edges) -> None:
    """The unfused route's two forms on one batch, both on the card: the
    hidden rows from the aligned keys (K7; the join carries no feature
    pairs) against the hidden layer over the feature pairs, with the same
    weights, fp32 at CPU_TOL and bf16 at ROUTE_TOL."""
    rows_be = (spgk.nodes, spgk.khi, spgk.klo, spgk.sizes, edges[:, :BATCH])
    keys = make_keys_join(NUM_WALKS, NUM_STEPS,
                          **net.join_outputs(DEVICE))(*rows_be)
    require(keys.eidx is None and keys.kcross_al is not None,
            "the unfused route's join on the card carries feature pairs")
    pairs = pair_join(NUM_WALKS, NUM_STEPS)(*rows_be)
    for dtype, tol in (("float32", CPU_TOL), ("bfloat16", ROUTE_TOL)):
        m = make_net(net.aggrs, dropout=0.1, dtype=dtype, fused_hidden=False,
                     key_layout=(NUM_WALKS, NUM_STEPS))
        m.load_state_dict(net.state_dict())
        with torch.inference_mode():
            got, want = m.eval()(keys), m(pairs)
        require(got.shape == (BATCH,) and bool(torch.isfinite(got).all()),
                f"the K7 route ({net.aggrs}, {dtype}) gave bad logits")
        err = float((got - want).abs().max())
        say(f"K7 route vs feature-pair route ({net.aggrs}, {dtype}), one "
            f"batch of {BATCH}: max |d logit| = {err:.3e}, max |logit| = "
            f"{float(want.abs().max()):.3e} (rtol = atol = {tol})")
        require(torch.allclose(got, want, rtol=tol, atol=tol),
                f"the K7 route ({net.aggrs}, {dtype}) disagrees with the "
                "feature-pair route")


def unfused_path(spgk: SpGKeys, edges, labels, label, launches) -> None:
    """The unfused keys routes on the bench sets (K7, and K7 bwd in
    training): `predict` of the mean, attn and lstm Nets (bf16,
    fused_hidden=False) through `trainer_from_keys`, whose join carries
    the aligned keys and no feature pairs; the K7 route against the
    feature-pair route; then for each aggregator the K7 route's fp32
    gradients against the fused route's, a cold fit (no synchronizing
    call) and a timed fit (mean 8 epochs, attn 4, lstm 1: its route is
    the plain scan), card-vs-CPU training and a profile of a few steps.
    The launch counts go into `launches`."""
    cfg = TrainConfig(batch_size=BATCH)
    nets = {a: make_net(a, dropout=0.1, dtype="bfloat16", fused_hidden=False,
                        key=prng.prng_key(0))
            for a in ("mean", "attn", "lstm")}
    serve = {a: trainer_from_keys(n, spgk, cfg) for a, n in nets.items()}
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    for a, trainer in serve.items():
        timed_predict(trainer, edges, label, f"{a}, unfused")
    launches["unfused_serve"] = counts()
    say(f"launches on the unfused serving path (mean, attn, lstm): "
        f"{launches['unfused_serve']}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for net in nets.values():
        check_unfused_routes(spgk, net, edges)
    paths = {"mean": ("unfused_train", N_EPOCHS, 8),
             "attn": ("unfused_attn_train", ATTN_EPOCHS, 8),
             "lstm": ("unfused_lstm_train", UNFUSED_LSTM_EPOCHS, 2)}
    for aggrs, (path, epochs, steps) in paths.items():
        trainer, _, _, key = train_setup(spgk, aggrs, fused_hidden=False)
        m = trainer.model
        be = edges[:, :BATCH]
        pair = held_route_grads(spgk, m, be, "float32", labels[:BATCH],
                                pairs=False)
        compare_grads("float32, random labels, the plain route on K7 (the "
                      "hidden rows from the keys)", m, pair,
                      GRAD_ROUTE_TOL["float32"])
        del pair
        fit_cold(trainer, edges, labels, key, epochs)
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        fit_timed(trainer, edges, labels, key, epochs, label)
        launches[path] = counts()
        say(f"launches on the unfused training path ({aggrs}, timed fit): "
            f"{launches[path]}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        check_train_cpu(spgk, m, edges, labels, fused_hidden=False)
        profile_train(trainer, edges, labels, key, steps=steps)


def cli_path(label, launches, log_root):
    """The link-prediction CLI on the fixtures: `run_experiment` on the
    card for each of CLI_ROWS (data prep, sampling, training, evaluation,
    early stopping, checkpoints), its log and checkpoints under
    `log_root/<row>`. Prints each row's evaluations, best (valid, test)
    and seconds; requires every evaluated value finite and the best pair
    above CLI_FLOOR; counts each row's launches; then holds the row's
    kernels to their plain versions on its own sets and weights
    (`cli_kernels`). Returns RESUME_ROW's config, final parameters and
    results, for `cli_resume_path`."""
    straight = None
    for row, kw in CLI_ROWS.items():
        cfg = apply_dataset_overrides(ExperimentConfig(
            num_steps=3, epochs=CLI_EPOCHS, eval_steps=2, early_stop=10,
            runs=1, log_dir=os.path.join(log_root, row), **kw))
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = run_experiment(cfg, device=DEVICE)
        sync()
        dt = time.perf_counter() - t0
        if row == RESUME_ROW:
            straight = (cfg, {k: v.detach().clone() for k, v in
                              out["trainer"].model.state_dict().items()},
                        out["results"])
        path = f"cli_{row}"
        launches[path] = counts()
        per_key = out["results"].results
        per_key = per_key if isinstance(per_key, dict) else {
            cfg.metric: per_key}
        evals = per_key[cfg.metric][0]
        best = out["best"][0]
        say(f"cli {row} ({cfg.dataset}, {cfg.aggrs}, {cfg.sencoder}, "
            f"{cfg.engine} engine"
            f"{', classes ' + cfg.balance_widths if cfg.balance_widths else ''}"
            f", M={cfg.num_walks}, "
            f"batch {cfg.batch_size}, {CLI_EPOCHS} epochs): {cfg.metric} "
            f"(valid, test) by eval {[tuple(e[1:]) for e in evals]}, best "
            f"{best} in {dt:.2f} s; launches "
            f"{ {k: v for k, v in launches[path].items() if v} }; peak device "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
            f"[{label}]")
        values = [x for res in per_key.values() for e in res[0]
                  for x in e[1:]]
        require(len(evals) == 2 and all(math.isfinite(x) for x in values),
                f"cli {row}: an evaluation is missing or not finite")
        require(min(best) > CLI_FLOOR[cfg.metric],
                f"cli {row}: best {cfg.metric} {best} not above "
                f"{CLI_FLOOR[cfg.metric]}")
        cli_kernels(row, out["trainer"], out["edges"])
        del out
    return straight


def cli_resume_path(label, launches, straight, log_root) -> None:
    """Checkpoints on the card. On RESUME_ROW's straight run (cli_path's,
    4 epochs, `latest_0` written before its epoch-2 evaluation): a
    `--resume latest_0` run, which trains epoch 3 alone, its parameters
    within RESUME_RTOL / RESUME_ATOL of the straight run's (the largest
    difference and whether they are bitwise equal printed); then
    `--inf_only --load_model latest_0`, equal to the straight run's
    epoch-2 evaluation exactly (K1 and K2 repeat bit for bit, and the
    sets are sampled anew from the same seed). Then the tags row of the
    higher-order CLI with an evaluation an epoch and `--early_stop 1`,
    which writes its checkpoint at the first evaluation that does not
    improve, and `--inf_only --load_model` over that checkpoint, equal to
    the run's last evaluation exactly. Each run's launches counted as a
    path of its own."""
    cfg, final, results = straight
    ckpt = f"{cfg.log_dir}/{cfg.dataset}/model/latest_0"
    state = load_checkpoint(ckpt)
    require(state["epoch"] == 2 and sorted(state) == [
        "epoch", "key", "opt_state", "params", "rng"],
            f"cli resume: {ckpt} holds epoch {state['epoch']}, fields "
            f"{sorted(state)}")

    def run(path, fn, cfg_):
        zero_counts()
        t0 = time.perf_counter()
        out = fn(cfg_, device=DEVICE)
        sync()
        launches[path] = counts()
        return out, time.perf_counter() - t0

    out, dt = run("cli_resume", run_experiment,
                  dataclasses.replace(cfg, resume=ckpt))
    got = out["trainer"].model.state_dict()
    worst, close, bitwise = 0.0, True, True
    for k, want in final.items():
        g = got[k].detach()
        worst = max(worst, (g - want).abs().max().item())
        close &= torch.allclose(g, want, rtol=RESUME_RTOL, atol=RESUME_ATOL)
        bitwise &= torch.equal(g, want)
    say(f"cli resume ({RESUME_ROW}, --resume latest_0 at epoch 2, epoch 3 "
        f"trained) in {dt:.2f} s: parameters against the straight run's "
        f"max |d| {worst:.3e} (rtol {RESUME_RTOL}, atol {RESUME_ATOL}), "
        f"bitwise equal: {bitwise}; launches "
        f"{ {k: v for k, v in launches['cli_resume'].items() if v} } "
        f"[{label}]")
    require(close, f"cli resume: parameters differ from the straight "
                   f"run's by up to {worst:.3e}")
    del out

    out, dt = run("cli_inf_only", run_experiment,
                  dataclasses.replace(cfg, inf_only=True, load_model=ckpt))
    per_key = results.results
    want = ({k: v[0][1] for k, v in per_key.items()}
            if isinstance(per_key, dict) else per_key[0][1])
    say(f"cli inf_only ({RESUME_ROW}, --load_model latest_0) in {dt:.2f} s:"
        f" {out['results']}; the straight run's epoch-2 evaluation {want}; "
        f"equal: {out['results'] == want}; launches "
        f"{ {k: v for k, v in launches['cli_inf_only'].items() if v} } "
        f"[{label}]")
    require(out["results"] == want,
            "cli inf_only: the evaluation differs from the straight run's")

    hcfg = ExperimentConfig(num_steps=3, epochs=HSTOP_EPOCHS, eval_steps=1,
                            early_stop=1, runs=1,
                            log_dir=os.path.join(log_root, "tags_stop"),
                            **CLI_HROW)
    out, dt = run("cli_tags_honet_stop", main_horder.run_experiment, hcfg)
    evals = out["results"].results[0]
    stops = glob.glob(f"{hcfg.log_dir}/{hcfg.dataset}/model/*_0")
    say(f"cli tags_honet --early_stop 1 in {dt:.2f} s: MRR (valid, test) "
        f"by epoch {[tuple(e[1:]) for e in evals]}; checkpoints {stops}")
    require(len(evals) < HSTOP_EPOCHS and len(stops) == 1,
            "cli tags_honet --early_stop 1: no stop, or no checkpoint")
    require(load_checkpoint(stops[0])["epoch"] == len(evals) - 1,
            "cli tags_honet: the checkpoint is not of the stopping epoch")
    del out
    out, dt = run("cli_horder_inf_only", main_horder.run_experiment,
                  dataclasses.replace(hcfg, inf_only=True,
                                      load_model=stops[0]))
    say(f"cli horder inf_only (--load_model {os.path.basename(stops[0])}) "
        f"in {dt:.2f} s: {out['results']}; the run's evaluation at epoch "
        f"{len(evals) - 1} {evals[-1]}; equal: {out['results'] == evals[-1]}"
        f"; launches "
        f"{ {k: v for k, v in launches['cli_horder_inf_only'].items() if v} }"
        f" [{label}]")
    require(out["results"] == evals[-1],
            "cli horder inf_only: the evaluation differs from the run's")


def mag_npz(path) -> float:
    """MAG_DATA's relation, valid and test cut to their first MAG_QUERIES
    sources, written to `path` (named mag_cite.npz, so that the CLI's mag
    branch reads it). Returns the seconds it took."""
    t0 = time.perf_counter()
    ds = synthetic_hetero_data(**MAG_DATA)
    for split in ("valid", "test"):
        ds.split_edge[split] = {k: v[:MAG_QUERIES]
                                for k, v in ds.split_edge[split].items()}
    ds.to_npz(path)
    return time.perf_counter() - t0


def cli_mag_path(label, launches, log_root) -> None:
    """Relation prediction on the card: `run_experiment` on MAG(P-P) at
    CLI_MAG over a MAG_DATA npz (`mag_npz`), one run of CLI_EPOCHS epochs
    (evaluations after epochs 0 and 2), its launches counted as
    `cli_mag`. Prints each evaluation, the seconds of the data, the CLI's
    prep (sampling both graphs), training and evaluation, and the peak
    device memory; requires every MRR finite and in [0, 1] (uniform random
    relations carry no signal, so no floor); then holds K1, K1 bwd and K2
    to their plain versions on the row's first training batch with its
    trained weights (`cli_kernels`)."""
    path = os.path.join(log_root, "mag_cite.npz")
    t_data = mag_npz(path)
    cfg = apply_dataset_overrides(ExperimentConfig(
        dataset=f"npz:{path}", epochs=CLI_EPOCHS, eval_steps=2,
        early_stop=10, runs=1, log_dir=os.path.join(log_root, "mag"),
        **CLI_MAG))
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = run_experiment(cfg, device=DEVICE)
    sync()
    dt = time.perf_counter() - t0
    launches["cli_mag"] = counts()
    phases = metrics.report()
    evals = out["results"].results[0]
    values = [x for e in evals for x in e[1:]]
    trainer = out["trainer"]
    say(f"cli mag (MAG(P-P) cites, {MAG_DATA['num_authors'] + MAG_DATA['num_papers']} "
        f"nodes, {MAG_DATA['num_writes']} writes, {MAG_DATA['num_cites']} "
        f"cites; M={cfg.num_walks}, num_steps {cfg.num_steps} "
        f"(L={trainer.rows[0].shape[1]}), {cfg.aggrs}, hidden "
        f"{cfg.hidden_channels}, k={cfg.k}, batch {cfg.batch_size}, "
        f"{MAG_QUERIES} x {MAG_DATA['neg_per_query'] + 1} pairs a split, "
        f"{CLI_EPOCHS} epochs of {out['edges'].shape[1]} queries): {cfg.metric} "
        f"(valid, test) by eval {[tuple(e[1:]) for e in evals]} in "
        f"{dt:.2f} s (data written in {t_data:.2f} s; prep "
        f"{phases['prep'].total_s:.2f} s, training "
        f"{phases['train_epoch'].total_s:.2f} s, evaluation "
        f"{phases['eval'].total_s:.2f} s, the rest the load and the host "
        f"data prep); launches "
        f"{ {k: v for k, v in launches['cli_mag'].items() if v} }; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB [{label}]")
    require(cfg.metric == "MRR" and len(evals) == 2
            and all(math.isfinite(x) and 0.0 <= x <= 1.0 for x in values),
            "cli mag: an evaluation is missing, not finite or not in [0, 1]")
    cli_kernels("mag", trainer, out["edges"])


def on_edges(indptr, indices, a, b) -> bool:
    """Whether every step a -> b follows an edge of the CSR graph, or stays
    on a node without one."""
    n = indptr.shape[0] - 1
    keys = torch.repeat_interleave(
        torch.arange(n, device=indptr.device), indptr[1:] - indptr[:-1]
    ) * n + indices
    want = a * n + b
    pos = torch.searchsorted(keys, want).clamp(max=keys.shape[0] - 1)
    dead = indptr[a + 1] == indptr[a]
    return bool(torch.where(dead, a == b, keys[pos] == want).all())


def legacy_path(g, label) -> None:
    """The SUREL-v1 legacy API over LEGACY_SEEDS seeds of the bench graph,
    on the card: `walk_sampler` (M=100, S'=3; every walk starts at its
    root and steps along edges, each column's landing mass is M, the sets
    hold the walks' nodes), `rw_matrix` (M=200, num_steps 4: 1-based
    values, the zero row, a real dedup, each value pointing at its node's
    count row), `batch_sampler` (the union sorted, holding the walks and
    the queries) and `walk_join` over random pairs of the walks' rows,
    exactly its CPU result. Prints each call's seconds."""
    seeds = np.arange(LEGACY_SEEDS, dtype=np.int32)
    indptr, indices = g.to(DEVICE)
    t0 = time.perf_counter()
    walks, (nodes, counts, sizes) = legacy.walk_sampler(
        g, seeds, num_walks=NUM_WALKS, num_steps=NUM_STEPS, device=DEVICE)
    t_walk = time.perf_counter() - t0
    w = torch.as_tensor(walks, dtype=torch.int64).to(DEVICE).reshape(
        LEGACY_SEEDS, NUM_WALKS, NUM_STEPS + 1)
    roots = bool((w[:, :, 0] == torch.as_tensor(seeds).to(DEVICE)[:, None]
                  ).all())
    steps = on_edges(indptr, indices, w[..., :-1].reshape(-1),
                     w[..., 1:].reshape(-1))
    valid = np.arange(nodes.shape[1])[None, :] < sizes[:, None]
    mass = bool(((counts * valid[:, :, None]).sum(axis=1) == NUM_WALKS).all())
    sets = all(np.array_equal(nodes[i, :sizes[i]], np.unique(walks[i]))
               for i in range(0, LEGACY_SEEDS, 4099))
    say(f"legacy walk_sampler ({LEGACY_SEEDS} seeds, M={NUM_WALKS}, "
        f"S'={NUM_STEPS}): {t_walk:.2f} s; roots at position 0: {roots}, "
        f"steps along edges: {steps}, landing mass M a column: {mass}, "
        f"sets the walks' nodes (every 4099th seed): {sets} [{label}]")
    require(roots and steps and mass and sets,
            "legacy walk_sampler: an invariant fails")

    t0 = time.perf_counter()
    z, freqs = legacy.rw_matrix(g, seeds, num_walks=WIDE_WALKS,
                                num_steps=WIDE_STEPS, device=DEVICE)
    t_rw = time.perf_counter() - t0
    keys, rows, rsizes = legacy.np_sampling(
        g, seeds, bsize=65536, num_walks=WIDE_WALKS,
        num_steps=WIDE_STEPS - 1, device=DEVICE)
    owner = np.repeat(seeds, rsizes)
    pick = np.arange(0, len(keys), 997)
    points = np.array_equal(
        freqs[np.asarray(z[owner[pick], keys[pick]]).ravel()], rows[pick])
    ok = (z.data.min() >= 1 and z.data.max() == len(freqs) - 1
          and not freqs[0].any() and len(freqs) - 1 < z.nnz == len(keys)
          and points)
    say(f"legacy rw_matrix ({LEGACY_SEEDS} seeds, M={WIDE_WALKS}, "
        f"num_steps {WIDE_STEPS}): {t_rw:.2f} s; {z.nnz} entries, "
        f"{len(freqs) - 1} distinct count rows; values 1-based, zero row, "
        f"values pointing at their rows (every 997th): {ok} [{label}]")
    require(ok, "legacy rw_matrix: an invariant fails")

    t0 = time.perf_counter()
    union, bwalks = legacy.batch_sampler(g, seeds, num_walks=NUM_WALKS,
                                         num_steps=NUM_STEPS, device=DEVICE)
    t_batch = time.perf_counter() - t0
    ok = (bool(np.all(np.diff(union) > 0))
          and np.array_equal(union, np.union1d(seeds, bwalks.ravel())))
    say(f"legacy batch_sampler ({LEGACY_SEEDS} queries, M={NUM_WALKS}, "
        f"S'={NUM_STEPS}): {t_batch:.2f} s; union of {len(union)} nodes, "
        f"sorted and exactly the queries' and walks' nodes: {ok} [{label}]")
    require(ok, "legacy batch_sampler: an invariant fails")

    rng = np.random.default_rng(17)
    queries = rng.integers(0, LEGACY_SEEDS, size=(2, LEGACY_SEEDS))
    legacy.walk_join(walks[:8], seeds[:8], queries[:, :8] % 8,
                     device=DEVICE)                  # warm
    sync()
    t0 = time.perf_counter()
    left, right = legacy.walk_join(walks, seeds, queries, device=DEVICE)
    t_join = time.perf_counter() - t0
    t0 = time.perf_counter()
    cleft, cright = legacy.walk_join(walks, seeds, queries, device="cpu")
    t_cpu = time.perf_counter() - t0
    same = np.array_equal(left, cleft) and np.array_equal(right, cright)
    say(f"legacy walk_join ({LEGACY_SEEDS} queries x {walks.shape[1]} walk "
        f"slots): card {t_join:.3f} s (with the copies both ways), CPU "
        f"{t_cpu:.3f} s; card equal to the CPU exactly: {same}; slots "
        f"found in the partner's walks {float((left > 0).mean()):.4f} "
        f"[{label}]")
    require(same, "legacy walk_join: the card differs from the CPU")


def cli_kernels(row, trainer, edges) -> None:
    """The row's kernels on the row's own operands: the first batch of its
    training edges joined over its sets by its trainer, with the weights
    its run left, each folded as `Net.forward` folds them. The forward and
    the backward of the row's aggregator kernel (K1, K3 or K4; the
    backward on a seeded cotangent) and K2 on the batch's merge rows, each
    against its plain version at the tolerances of phase 2; for a scalar
    row K2 on the values' bits and, for lstm, K5 and K5 bwd
    (`scalar_kernels`); for a host-engine row K2 on the table indices."""
    be = torch.as_tensor(edges[:, :trainer.config.batch_size]).to(DEVICE)
    if isinstance(trainer, LinkPredictor):
        sets = trainer.dev
        k2_compare(merge_rows(sets.nodes[be], sets.eidx[be]),
                   f"cli {row} (host engine, table sets, a training batch)")
        return
    model, sets = trainer.model, trainer.sets
    if scalar_sets(sets):
        scalar_kernels(trainer, be, f"cli {row} (scalar sets, trained "
                                    f"weights, a training batch)")
        return
    with torch.no_grad():
        joined, _ = trainer._batch(be)
        shift = int(model.key_layout[0]).bit_length()
        u_ext = model._u_ext()
        w2, bias2 = (t.to(torch.float32) for t in
                     model.pe_embedding.project_raw())
        c2 = 2.0 * bias2[None]
        if model.aggrs == "attn":
            gate = model.aggr.gate_nn
            wg = gate.weight.t().to(torch.float32)
            gv = torch.cat([w2 @ wg, c2 @ wg + gate.bias.to(torch.float32)])
        elif model.aggrs == "lstm":
            cd, wi = model.dtype, model.aggr.wi
            wi_eff = (w2.to(cd) @ wi.to(cd)).to(torch.float32)
            bh_eff = model.aggr.bh.to(torch.float32) + (
                c2 @ wi.to(torch.float32)).reshape(-1)
            wh = model.aggr.wh.detach().to(torch.float32)
    nw, ns = model.key_layout
    tag = (f"cli {row} (M={nw}, S'={ns}, trained weights, a training "
           f"batch)")
    gen = torch.Generator().manual_seed(21)
    g = torch.randn(2, be.shape[1], model.hidden_dim,
                    generator=gen).to(DEVICE)
    if model.aggrs == "mean":
        args = (joined.kown, joined.mask, joined.kcross, joined.kcross_mask,
                u_ext, shift, joined.kown_root, joined.kcross_root)
        k1_compare(args, tag)
        k1b_compare(args, g, tag)
    elif model.aggrs == "attn":
        args = (joined.kown, joined.kcross_al, joined.mask, u_ext, gv,
                shift, joined.kown_root, joined.kcross_al_root)
        attn_compare(args, tag)
        attn_bwd_compare(args, g, tag)
    else:
        args = (joined.kown, joined.kcross_al, joined.mask, u_ext, wi_eff,
                wh, bh_eff, shift, joined.kown_root, joined.kcross_al_root)
        lstm_compare(args, tag)
        lstm_bwd_compare(args, g, tag)
    k2_compare(merge_rows(sets.nodes[be], sets.klo[be]), tag)


# ------------------------------------------------------------ HONet
def make_honet(sets: SpGKeys, device=None, key=prng.prng_key(0),
               **kw) -> HONet:
    """HONet at the bench width (hidden 96) over `sets`' encodings, on the
    card unless `device` says otherwise, drawn from `key` (prng_key(0)
    unless given)."""
    return HONet(sets.num_steps + 1, HIDDEN, key=key,
                 device=DEVICE if device is None else device, **kw)


def honet_trainer(net: HONet, sets: SpGKeys, cfg):
    """`trainer_from_keys` over the hyperedge join, which builds what the
    model reads on the sets' device."""
    return trainer_from_keys(net, sets, cfg, join_factory=functools.partial(
        make_keys_hjoin, **net.join_outputs(sets.nodes.device)))


def honet_setup(sets: SpGKeys, batch: int, n_edges: int, seed: int = 0):
    """bench.py:274-293 on the port: HONet(96, dropout 0.1) from a seeded
    generator, its trainer over `sets`, `n_edges` random hyperedges with
    random 0/1 labels, and the key of the permutations and dropout
    masks."""
    net = make_honet(sets, dropout=0.1,
                     key=prng.prng_key(0))
    trainer = honet_trainer(net, sets, TrainConfig(
        batch_size=batch, lr=LR, grad_clip=GRAD_CLIP))
    rng = np.random.default_rng(seed)
    hedges = torch.as_tensor(rng.integers(
        0, sets.nodes.shape[0], size=(3, n_edges))).to(DEVICE)
    labels = torch.as_tensor((rng.random(n_edges) < 0.5).astype(
        np.float32)).to(DEVICE)
    return trainer, hedges, labels, prng.prng_key(5)


def honet_check_routes(sets: SpGKeys, net: HONet, hedges) -> None:
    """The fused route (K1 over the key planes) against the unfused route
    (the hidden layer over the feature pairs) on one batch, both on the
    card, fp32 at CPU_TOL; then the card against the port's CPU path on
    N_REF queries (scores at CPU_TOL)."""
    state = net.state_dict()
    be = hedges[:, :BATCH]
    rows = (sets.nodes, sets.khi, sets.klo, sets.sizes, be)
    nw, ns = sets.num_walks, sets.num_steps
    plain = make_honet(sets, fused_hidden=False)
    plain.load_state_dict(state)
    with torch.inference_mode():
        keys = make_keys_hjoin(nw, ns, **net.join_outputs(DEVICE))(*rows)
        require(keys.eidx is None and keys.kcross is not None,
                "HONet's join on the card builds feature pairs")
        got = net.eval()(keys)
        want = plain.eval()(make_keys_hjoin(nw, ns)(*rows))
    require(got.shape == (BATCH,) and bool(torch.isfinite(got).all()),
            "HONet's fused route gave bad logits")
    err = float((got - want).abs().max())
    say(f"HONet fused vs unfused route, one batch of {BATCH} (fp32): max "
        f"|d logit| = {err:.3e}, max |logit| = {float(want.abs().max()):.3e}"
        f" (rtol = atol = {CPU_TOL})")
    require(torch.allclose(got, want, rtol=CPU_TOL, atol=CPU_TOL),
            "HONet's fused route disagrees with its unfused route")
    small, cpu_small, remap = subset(sets, be[:, :N_REF])
    scores = {}
    for dev, part in ((DEVICE, small), ("cpu", cpu_small)):
        m = make_honet(sets, device=dev)
        m.load_state_dict(state)
        scores[dev] = honet_trainer(m, part, TrainConfig(
            batch_size=N_REF)).predict(remap.to(dev)).cpu()
    err = float((scores[DEVICE] - scores["cpu"]).abs().max())
    say(f"HONet card vs CPU path, {N_REF} queries (fp32): max |d score| = "
        f"{err:.3e} (rtol = atol = {CPU_TOL})")
    require(torch.allclose(scores[DEVICE], scores["cpu"], rtol=CPU_TOL,
                           atol=CPU_TOL),
            "HONet on the card disagrees with the port's CPU path")


def honet_train_cpu(sets: SpGKeys, net: HONet, hedges, labels) -> None:
    """REF_STEPS training steps on the card (the fused route: K1, K1 bwd,
    K2) against the port's CPU path (the unfused route), fp32, dropout 0,
    one shared permutation."""
    n = REF_STEPS * REF_BATCH
    small, cpu_small, remap = subset(sets, hedges[:, :n])
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(4))
    cfg = TrainConfig(batch_size=REF_BATCH, lr=LR, grad_clip=GRAD_CLIP)
    out = {}
    for dev, part in ((DEVICE, small), ("cpu", cpu_small)):
        m = make_honet(sets, dropout=0.0, device=dev)
        m.load_state_dict(net.state_dict())
        losses, _ = honet_trainer(m, part, cfg).fit(
            remap.to(dev), labels[:n].to(dev), 1, prng.prng_key(0),
            perms=[perm.reshape(REF_STEPS, REF_BATCH)])
        out[dev] = (losses.cpu(), {k: v.cpu() for k, v in
                                   m.state_dict().items()})
    (lg, pg), (lc, pc) = out[DEVICE], out["cpu"]
    err = max(float((pg[k] - pc[k]).abs().max()) for k in pc)
    ok = all(torch.allclose(pg[k], pc[k], rtol=CPU_TRAIN_RTOL,
                            atol=CPU_TRAIN_ATOL) for k in pc)
    say(f"HONet card vs CPU training, {REF_STEPS} steps x {REF_BATCH} "
        f"queries (fp32): loss {float(lg[0]):.6f} vs {float(lc[0]):.6f}, "
        f"max |d param| = {err:.3e} (rtol {CPU_TRAIN_RTOL}, atol "
        f"{CPU_TRAIN_ATOL}) {'ok' if ok else 'FAIL'}")
    require(ok and torch.allclose(lg, lc, rtol=1e-5),
            "HONet's training on the card disagrees with the port's CPU "
            "path")


def k1_halves(q4):
    """K1's operands over a hyperedge join's [B, 4L] plane (`q4`) as the
    two Q=2 halves `group_set_sums` launches: groups 0-1 over the plane's
    first half, 2-3 over its second, the cross planes row-strided views."""
    kown, mown, kcross, mcross, u_ext, shift, rown, rcross = q4
    half = kcross.shape[1] // 2
    out = []
    for g, c in ((slice(0, 2), slice(0, half)),
                 (slice(2, 4), slice(half, 2 * half))):
        out.append((kown[g], mown[g], kcross[:, c], mcross[g, :, c], u_ext,
                    shift, None if rown is None else rown[g],
                    None if rcross is None else rcross[:, c]))
    return out


def honet_batch(trainer, hedges):
    """The first training batch of `hedges` joined by the HONet trainer,
    with the weights its model holds: the join, K1's operands in both
    forms (Q=4 over [B, 4L], the two Q=2 halves) and the two merges'
    operands, (u, w) and (v, w)."""
    model, sets = trainer.model, trainer.sets
    be = hedges[:, :trainer.config.batch_size].contiguous()
    with torch.no_grad():
        joined, _ = trainer._batch(be)
        u_ext = model._u_ext()
    shift = int(model.key_layout[0]).bit_length()
    q4 = (joined.kown, joined.mask, joined.kcross, joined.kcross_mask,
          u_ext, shift, joined.kown_root, joined.kcross_root)
    rn, rl = sets.nodes[be], sets.klo[be]
    merges = [merge_rows(torch.stack([rn[a], rn[2]]),
                         torch.stack([rl[a], rl[2]])) for a in (0, 1)]
    return joined, q4, k1_halves(q4), merges


def honet_kernels(trainer, hedges, tag, gen):
    """K1 (both forms), K1 bwd on a seeded cotangent and K2 (both merges) on
    one HONet batch (`honet_batch`), each against its plain version at
    phase 2's tolerances, two launches bit for bit. Returns the batch and
    the cotangent."""
    joined, q4, halves, merges = honet_batch(trainer, hedges)
    g4 = torch.randn(4, q4[0].shape[1], trainer.model.hidden_dim,
                     generator=gen).to(DEVICE)
    k1_compare(q4, f"{tag}, Q=4 over [B, 4L]")
    k1b_compare(q4, g4, f"{tag}, Q=4 over [B, 4L]")
    for i, h in enumerate(halves):
        k1_compare(h, f"{tag}, Q=2 half {i}")
        k1b_compare(h, g4[2 * i:2 * i + 2], f"{tag}, Q=2 half {i}")
    for m, which in zip(merges, ("(u, w)", "(v, w)")):
        k2_compare(m, f"{tag}, merge {which}")
    return joined, q4, halves, g4


def honet_form_times(batch, label) -> None:
    """The fused route's set sums in its two forms, one Q=4 launch over
    [B, 4L] against the route's two Q=2 launches over the halves
    (row-strided views): the kernels' forward, backward, and forward and
    backward together, each as issued and queued (the last, queued, is
    what chose the route), and each form's forward and its forward and
    backward through autograd, as issued."""
    joined, q4, halves, g4 = batch
    fwd = hidden_sum.fused_key_hidden_sum_cuda
    bwd = hidden_sum.fused_key_hidden_sum_bwd_cuda
    u_ext, shift = q4[4], q4[5]

    def k1_both(args, g):
        fwd(*args)
        k1b_call(bwd, args, g)

    def sums_q4(u):
        kown, mown, kcross, mcross, _, _, rown, rcross = q4
        return hidden_sum.fused_key_hidden_sum(
            kown, mown, kcross, mcross, u, shift, root_own=rown,
            root_cross=rcross)

    def through_autograd(sums, backward):
        u = u_ext.detach().requires_grad_(backward)
        out = sums(u)
        if backward:
            out.backward(g4)

    kernels = {
        "K1 forward, one Q=4 launch": lambda: fwd(*q4),
        "K1 forward, two Q=2 launches": lambda: [fwd(*h) for h in halves],
        "K1 bwd, one Q=4 launch": lambda: k1b_call(bwd, q4, g4),
        "K1 bwd, two Q=2 launches": lambda: [
            k1b_call(bwd, h, g4[2 * i:2 * i + 2])
            for i, h in enumerate(halves)],
        "K1 forward and bwd, one Q=4 launch each": lambda: k1_both(q4, g4),
        "K1 forward and bwd, two Q=2 launches each": lambda: [
            k1_both(h, g4[2 * i:2 * i + 2]) for i, h in enumerate(halves)]}
    for name, fn in kernels.items():
        say(f"HONet set sums {label}, {name}: {time_ms(fn):.4f} ms as "
            f"issued, {queued_ms(fn):.4f} ms queued")
    b1, b1b = k1_bound(q4), k1b_bound(q4, g4)
    say(f"HONet set sums {label}: K1's bound {b1[0]:.4f} ms ({b1[1]}), "
        f"K1 bwd's {b1b[0]:.4f} ms ({b1b[1]}), either form")
    for form, sums in (("one Q=4 launch", sums_q4),
                       ("two Q=2 launches, the route",
                        lambda u: group_set_sums(joined, u, shift))):
        with torch.no_grad():
            t_f = time_ms(lambda: through_autograd(sums, False))
        t_fb = time_ms(lambda: through_autograd(sums, True))
        say(f"HONet set sums {label}, {form}: forward {t_f:.4f} ms, "
            f"forward and backward through autograd {t_fb:.4f} ms, as "
            f"issued")


def honet_path(spgk: SpGKeys, spw: SpGKeys, label, launches) -> None:
    """HONet, the hyperedge path (bench.py:274-307), on the main path's
    sets: `predict` over 65,536 random hyperedges (`honet_serve`), the
    fused route against the unfused one and the card against the CPU, a
    cold fit (no synchronizing call) and a timed fit of 2 epochs
    (`honet_train`), card-vs-CPU training, a profile of a few steps, its
    kernels on its own batch and the two forms' times; then a fit at the
    tags-math class shape (M=200, S'=4, L=801, batch 2048:
    `honet_tags_train`) with its kernels and the two forms' times there."""
    trainer, hedges, labels, key = honet_setup(spgk, BATCH, H_EDGES)
    net = trainer.model
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    timed_predict(trainer, hedges, label, "honet")
    launches["honet_serve"] = counts()
    say(f"launches on the HONet serving path: {launches['honet_serve']}; "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    honet_check_routes(spgk, net, hedges)
    fit_cold(trainer, hedges, labels, key, H_EPOCHS)
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    fit_timed(trainer, hedges, labels, key, H_EPOCHS, label)
    launches["honet_train"] = counts()
    say(f"launches on the HONet training path (timed fit): "
        f"{launches['honet_train']}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    honet_train_cpu(spgk, net, hedges, labels)
    profile_train(trainer, hedges, labels, key)
    kgen = torch.Generator().manual_seed(22)
    honet_form_times(honet_kernels(
        trainer, hedges, f"HONet lo-only M={NUM_WALKS} S'={NUM_STEPS}",
        kgen), f"lo-only (L={spgk.nodes.shape[1]}, B={BATCH})")
    del trainer, hedges, labels

    ttrainer, thedges, tlabels, tkey = honet_setup(
        spw, TAGS_BATCH, TAGS_BATCH * TAGS_STEPS, seed=1)
    fit_cold(ttrainer, thedges, tlabels, tkey, 1)
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    fit_timed(ttrainer, thedges, tlabels, tkey, 1, label)
    launches["honet_tags_train"] = counts()
    say(f"launches on the HONet fit at the tags-math class shape (M="
        f"{spw.num_walks}, S'={spw.num_steps}, L={spw.nodes.shape[1]}, "
        f"batch {TAGS_BATCH}): {launches['honet_tags_train']}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    honet_form_times(honet_kernels(
        ttrainer, thedges, f"HONet lead-in-hi M={spw.num_walks} "
        f"S'={spw.num_steps}", kgen),
        f"lead-in-hi (L={spw.nodes.shape[1]}, B={TAGS_BATCH})")


def cli_horder_path(label, launches) -> None:
    """The higher-order CLI on the tags fixture: `main_horder.run_experiment`
    on the card at the row's flags (CLI_HROW), on each engine of
    CLI_HROWS, one run of CLI_EPOCHS epochs, its log in a temporary
    directory, its launches counted as `cli_<row>`; every evaluated MRR
    finite and the best pair above CLI_FLOOR; then its kernels on its
    first training batch over its sets, with the weights its run left
    (the host engine's K2 on the (u, w) rows of its table join)."""
    for row, extra in CLI_HROWS.items():
        cfg = ExperimentConfig(num_steps=3, epochs=CLI_EPOCHS, eval_steps=2,
                               early_stop=10, runs=1, **CLI_HROW, **extra)
        with tempfile.TemporaryDirectory() as log_dir:
            cfg.log_dir = log_dir
            zero_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = main_horder.run_experiment(cfg, device=DEVICE)
            sync()
            dt = time.perf_counter() - t0
        path = f"cli_{row}"
        launches[path] = counts()
        evals = out["results"].results[0]
        best = out["best"][0]
        say(f"cli {row} (tags fixture, HONet, {cfg.engine} engine, "
            f"M={cfg.num_walks}, batch {cfg.batch_size}, {CLI_EPOCHS} "
            f"epochs): MRR (valid, test) by eval "
            f"{[tuple(e[1:]) for e in evals]}, best {best} in {dt:.2f} s; "
            f"launches { {k: v for k, v in launches[path].items() if v} }; "
            f"peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{label}]")
        require(len(evals) == 3 and all(math.isfinite(x) for e in evals
                                        for x in e[1:]),
                f"cli {row}: an evaluation is missing or not finite")
        require(min(best) > CLI_FLOOR["MRR"],
                f"cli {row}: best MRR {best} not above {CLI_FLOOR['MRR']}")
        trainer = out["trainer"]
        if isinstance(trainer, LinkPredictor):
            be = torch.as_tensor(out["edges"][:, :cfg.batch_size]).to(DEVICE)
            uw = torch.stack([be[0], be[2]])
            k2_compare(merge_rows(trainer.dev.nodes[uw],
                                  trainer.dev.eidx[uw]),
                       f"cli {row} (host engine, table sets, the (u, w) "
                       f"merge of a training batch)")
            continue
        sets = trainer.sets
        honet_kernels(trainer, out["edges"],
                      f"cli {row} (M={sets.num_walks}, S'={sets.num_steps},"
                      f" trained weights, a training batch)",
                      torch.Generator().manual_seed(23))



# ------------------------------------------------------------ scalar path
def scalar_sets_of(g, label) -> SpGDevice:
    """The scalar path's sets (the JAX CLI's `_scalar_pipeline`): the top-k
    PPR matrix of the host push (alpha, eps and topk the CLI's defaults),
    normalized 'sym', for every node, or for the first SCALAR_ROWS_CUT if
    a probe of PUSH_PROBE seeds predicts more than PUSH_BUDGET_S; the PPR
    encoding; the padded layout on the card."""
    t0 = time.perf_counter()
    ppr_ops.host_library()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ppr_ops.ppr_topk(g.indptr, g.indices, np.arange(PUSH_PROBE),
                     SCALAR_ALPHA, SCALAR_EPS, SCALAR_TOPK)
    probe_s = time.perf_counter() - t0
    rows = g.num_nodes
    if probe_s * g.num_nodes / PUSH_PROBE > PUSH_BUDGET_S:
        rows = SCALAR_ROWS_CUT
    idx = np.arange(rows)
    t0 = time.perf_counter()
    _, _, cnt = ppr_ops.ppr_topk(g.indptr, g.indices, idx, SCALAR_ALPHA,
                                 SCALAR_EPS, SCALAR_TOPK)
    push_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x = ppr_ops.topk_ppr_matrix(g, SCALAR_ALPHA, SCALAR_EPS, idx,
                                SCALAR_TOPK, normalization="sym")
    x, _ = encoding(x.tocsr(), g.to_scipy(), "PPR")
    sspg = scalar_spg_from_csr(x.tocsr())
    dev = sspg.device(DEVICE)
    sync()
    prep_s = time.perf_counter() - t0
    say(f"scalar sets: host push over {rows} of {g.num_nodes} seeds "
        f"({'all' if rows == g.num_nodes else 'cut: the probe predicted more than ' + str(PUSH_BUDGET_S) + ' s'}), "
        f"alpha {SCALAR_ALPHA}, eps {SCALAR_EPS}, topk {SCALAR_TOPK}, "
        f"{ppr_ops.num_threads()} threads: {push_s:.3f} s -> "
        f"{rows / push_s:.1f} seeds/s (build {build_s:.2f} s, probe of "
        f"{PUSH_PROBE} seeds {probe_s:.3f} s); mean set size "
        f"{float(cnt.mean()):.2f}; matrix, PPR encoding and padded sets "
        f"{prep_s:.3f} s; L={sspg.bucket} [{label}]")
    require(sspg.bucket <= SCALAR_TOPK and bool((sspg.sizes >= 1).all()),
            "the scalar sets are wider than topk, or a set is empty")
    return dev


def check_scalar_routes(dev: SpGDevice, net, edges) -> None:
    """The scalar Net's fused route against its unfused route on one batch
    (fp32 at CPU_TOL, bf16 at ROUTE_TOL, both on the card), and the card
    against the port's CPU path on N_REF queries (fp32)."""
    aggrs, state = net.aggrs, net.state_dict()
    be = edges[:, :BATCH]
    joined = gather_join_scalar(dev.nodes, dev.eidx, dev.sizes, be)
    for dtype, tol in (("float32", CPU_TOL), ("bfloat16", ROUTE_TOL)):
        fused, plain = (make_net(aggrs, dropout=0.1, dtype=dtype,
                                 fused_hidden=f, input_dim=1)
                        for f in (True, False))
        fused.load_state_dict(state)
        plain.load_state_dict(state)
        with torch.inference_mode():
            got = fused.eval()(joined, enc_table=dev.enc)
            want = plain.eval()(joined, enc_table=dev.enc)
        require(got.shape == (BATCH,) and bool(torch.isfinite(got).all()),
                f"scalar fused route ({aggrs}) gave bad logits")
        err = float((got - want).abs().max())
        say(f"scalar fused vs plain route ({aggrs}), one batch of {BATCH} "
            f"({dtype}): max |d logit| = {err:.3e}, max |logit| = "
            f"{float(want.abs().max()):.3e} (rtol = atol = {tol})")
        require(torch.allclose(got, want, rtol=tol, atol=tol),
                f"scalar fused route ({aggrs}, {dtype}) disagrees with the "
                f"plain route")
    small, cpu_small, remap = subset(dev, be[:, :N_REF])
    cfg = TrainConfig(batch_size=N_REF)
    gpu, cpu = (make_net(aggrs, dropout=0.1, device=d, input_dim=1)
                for d in (DEVICE, "cpu"))
    gpu.load_state_dict(state)
    cpu.load_state_dict(state)
    got = trainer_for(gpu, small, cfg).predict(remap)
    want = trainer_for(cpu, cpu_small, cfg).predict(remap.cpu())
    err = float((got.cpu() - want).abs().max())
    say(f"card vs CPU path ({aggrs}, scalar), {N_REF} queries (fp32): max "
        f"|d score| = {err:.3e} (rtol = atol = {CPU_TOL})")
    require(torch.allclose(got.cpu(), want, rtol=CPU_TOL, atol=CPU_TOL),
            "the card disagrees with the port's CPU path (scalar)")


def scalar_kernels(trainer, be, tag) -> None:
    """K2 on a scalar trainer's join batch `be` (the values' bits its
    payload) exactly, and for the lstm Net K5 and K5 bwd on the batch's
    own hidden rows (fp32 hsum of the Net's weights, its fold) at phase
    2's tolerances."""
    model, sets = trainer.model, trainer.sets
    be = be.contiguous()
    k2_compare(merge_rows(sets.nodes[be], sets.eidx[be].view(torch.int32)),
               tag)
    if model.aggrs != "lstm":
        return
    with torch.no_grad():
        joined, _ = trainer._batch(be)
        w1, b1 = (t.to(torch.float32)
                  for t in model.pe_embedding.hidden_raw())
        hsum = torch.relu(joined.eidx[..., None] @ w1 + b1).sum(dim=-2)
        w2, bias2 = (t.to(torch.float32)
                     for t in model.pe_embedding.project_raw())
        c2 = 2.0 * bias2[None]
        wi = model.aggr.wi.to(torch.float32)
        wi_eff = (w2 @ wi).contiguous()
        bh_eff = model.aggr.bh.to(torch.float32) + (c2 @ wi).reshape(-1)
        wh = model.aggr.wh.detach().to(torch.float32)
    q, b, ell = joined.mask.shape
    args = (hsum.reshape(q * b, ell, model.hidden_dim).contiguous(),
            joined.mask.reshape(q * b, ell).contiguous(), wi_eff, wh, bh_eff)
    lstm_check("K5", lstm_x.lstm_final_hidden_cuda,
               lstm_x.lstm_final_hidden_plain, args, args[1],
               table_x_label(args, tag))
    g = lstm_x_cotangent(args, torch.Generator().manual_seed(25))
    lstm_x_bwd_compare(args, g, tag)


def scalar_path(g, label, launches) -> None:
    """The scalar encoders' device path at the bench width: the PPR sets of
    every node (`scalar_sets_of`), `Net(1, 96, bf16)` with mean, attn and
    lstm through a scalar DeviceTrainer at batch 4096; predict on the
    32 x 4096 query edges among the rows, the route checks, a cold and a
    timed fit, the card against the CPU after REF_STEPS steps, profiles;
    K2 on the scalar join's batch and K5, K5 bwd on the lstm's hidden
    rows. The launch counts go into `launches`."""
    dev = scalar_sets_of(g, label)
    trainers, setups = {}, {}
    for aggrs in ("mean", "attn", "lstm"):
        setups[aggrs] = train_setup(dev, aggrs)
        trainers[aggrs] = setups[aggrs][0]
    edges, labels = setups["mean"][1], setups["mean"][2]
    zero_counts()
    for aggrs in ("mean", "attn"):
        timed_predict(trainers[aggrs], edges, label, f"{aggrs}, scalar")
    launches["scalar_serve"] = counts()
    say(f"launches on the scalar serving path (mean, attn): "
        f"{launches['scalar_serve']}")
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    lstm_serve(trainers["lstm"], edges, label)
    launches["scalar_lstm_serve"] = counts()
    say(f"launches on the scalar LSTM serving path: "
        f"{launches['scalar_lstm_serve']}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for aggrs in ("mean", "attn", "lstm"):
        check_scalar_routes(dev, trainers[aggrs].model, edges)
    profile_predict(dev, trainers["lstm"].model, edges)
    paths = {"mean": ("scalar_train", N_EPOCHS),
             "attn": ("scalar_attn_train", ATTN_EPOCHS),
             "lstm": ("scalar_lstm_train", LSTM_EPOCHS)}
    for aggrs, (path, epochs) in paths.items():
        trainer, _, _, key = setups[aggrs]
        fit_cold(trainer, edges, labels, key, epochs)
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        fit_timed(trainer, edges, labels, key, epochs, label)
        launches[path] = counts()
        say(f"launches on the scalar training path ({aggrs}, timed fit): "
            f"{launches[path]}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        check_train_cpu(dev, trainer.model, edges, labels)
        profile_train(trainer, edges, labels, key)
        scalar_kernels(trainer, edges[:, :BATCH],
                       f"scalar {aggrs} (PPR sets, trained weights, a "
                       f"training batch)")


# ------------------------------------------------------------ device PPR
def ppr_device_check(g, label) -> None:
    """`ppr_topk_device` on the card for PPR_SEEDS random seeds of the
    graph at the scalar path's settings, against a float64 power
    iteration of the first PPR_BLOCK seeds on the card (within the
    truncation's bound alpha eps) and against the host push on the nodes
    both top-k lists hold (within the push's own bound eps d_v: the push
    stops with every residual below alpha eps d_u, which on an undirected
    graph leaves a node's score short by less than eps d_v). The JAX
    test's 5e-4 and 90% shared support (tests/test_ppr.py:50-90) are
    printed beside: on this graph's hubs the push's bound is far above
    them. Prints seeds/s of both."""
    seeds = np.sort(np.random.default_rng(3).choice(
        g.num_nodes, PPR_SEEDS, replace=False)).astype(np.int32)
    args = (g.indptr, g.indices, seeds, SCALAR_ALPHA, SCALAR_EPS,
            SCALAR_TOPK)
    t0 = time.perf_counter()
    hn, hs, hc = ppr_ops.ppr_topk(*args)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ppr_topk_device(*args[:2], seeds[:PPR_BLOCK], *args[3:],
                    block=PPR_BLOCK, device=DEVICE)
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dn, ds, dc = ppr_topk_device(*args, block=PPR_BLOCK, device=DEVICE)
    dev_s = time.perf_counter() - t0
    say(f"PPR, {PPR_SEEDS} seeds, alpha {SCALAR_ALPHA}, eps {SCALAR_EPS}, "
        f"topk {SCALAR_TOPK}: host push {host_s:.4f} s -> "
        f"{PPR_SEEDS / host_s:.1f} seeds/s ({ppr_ops.num_threads()} "
        f"threads); device power iteration (block {PPR_BLOCK}) "
        f"{dev_s:.4f} s -> {PPR_SEEDS / dev_s:.1f} seeds/s (first block "
        f"cold {cold_s:.4f} s); mean counts host {float(hc.mean()):.2f}, "
        f"device {float(dc.mean()):.2f} [{label}]")
    # the float64 power iteration of the first block on the card
    n = g.num_nodes
    deg = torch.as_tensor(np.diff(g.indptr), dtype=torch.float64).to(DEVICE)
    adj = torch.sparse_csr_tensor(
        torch.as_tensor(g.indptr, dtype=torch.int64),
        torch.as_tensor(g.indices, dtype=torch.int64),
        torch.ones(g.num_edges, dtype=torch.float64), size=(n, n),
        check_invariants=True).to(DEVICE)
    inv = torch.where(deg > 0, 1.0 / deg.clamp(min=1), 0.0)
    e0 = torch.zeros(n, PPR_BLOCK, dtype=torch.float64, device=DEVICE)
    e0[torch.as_tensor(seeds[:PPR_BLOCK]).to(DEVICE).long(),
       torch.arange(PPR_BLOCK, device=DEVICE)] = 1.0
    x = SCALAR_ALPHA * e0
    for _ in range(EXACT_ITERS):
        x = SCALAR_ALPHA * e0 + (1 - SCALAR_ALPHA) * (adj @ (x * inv[:, None]))
    nodes = torch.as_tensor(dn[:PPR_BLOCK]).to(DEVICE).long()
    exact = torch.gather(x.T, 1, nodes).cpu().numpy()
    valid = np.arange(SCALAR_TOPK)[None, :] < dc[:PPR_BLOCK, None]
    d_exact = (exact - ds[:PPR_BLOCK])[valid]
    del x, e0, adj
    trunc = SCALAR_ALPHA * SCALAR_EPS
    ok_exact = bool((d_exact >= -2e-6).all() and (d_exact <= trunc + 2e-6)
                    .all())
    # against the host push on the shared support
    degs = np.diff(g.indptr).astype(np.float64)
    shared, worst, over, beyond = 0, 0.0, 0, 0
    for i in range(PPR_SEEDS):
        host = dict(zip(hn[i, :hc[i]].tolist(), hs[i, :hc[i]].tolist()))
        for v, score in zip(dn[i, :dc[i]].tolist(), ds[i, :dc[i]].tolist()):
            if v in host:
                d = score - host[v]
                shared += 1
                worst = max(worst, abs(d))
                over += abs(d) > PPR_TOL
                beyond += not (-trunc - 1e-6 <= d
                               <= SCALAR_EPS * degs[v] + 1e-6)
    share = shared / max(int(hc.sum()), 1)
    say(f"device PPR vs float64 power iteration ({PPR_BLOCK} seeds, "
        f"{EXACT_ITERS} steps): exact - device in "
        f"[{float(d_exact.min()):.3e}, {float(d_exact.max()):.3e}] (bound "
        f"[-2e-6, {trunc:.1e} + 2e-6]) {'ok' if ok_exact else 'FAIL'}")
    say(f"device PPR vs host push: {share:.4f} of the push's support "
        f"shared (the JAX test asks 0.9); on it max |d| {worst:.3e}, "
        f"{over} of {shared} entries beyond the JAX test's {PPR_TOL}; "
        f"{beyond} outside the push's bound [-alpha eps, eps d_v] "
        f"{'ok' if beyond == 0 else 'FAIL'}")
    require(ok_exact, "the device PPR is off the float64 power iteration")
    require(beyond == 0, "the device PPR and the host push differ by more "
                         "than the push's bound")


# ------------------------------------------------------------ balanced
def balanced_path(spgk: SpGKeys, edges, labels, label, launches) -> None:
    """Balanced batching (`fit_balanced`, `predict_balanced`) on the main
    path's keys sets and edges for the mean Net, and the attn Net's
    predict and one balanced epoch: the classes are the 50th and 90th
    percentiles of the queries' larger set size, rounded up to 32, and
    the bucket; `predict_balanced` against `predict` (1e-6, and whether
    bit-equal); a one-class `fit_balanced` at the bucket against `fit`
    with the same permutations (rtol 1e-4, atol 1e-6); a balanced and a
    plain fit timed in turns (BAL_TURNS each, medians printed)."""
    bucket = spgk.nodes.shape[1]
    e_h = edges.cpu().numpy()
    req = spgk.sizes.cpu().numpy()[e_h].max(axis=0)
    classes = tuple(sorted({min(bucket, -(-int(np.percentile(req, p))
                                         // 32) * 32) for p in (50, 90)}
                           | {bucket}))
    cfg = TrainConfig(batch_size=BATCH, lr=LR, grad_clip=GRAD_CLIP)
    nets = {a: make_net(a, dropout=0.1, dtype="bfloat16",
                        key=prng.prng_key(0))
            for a in ("mean", "attn")}
    trainers = {a: trainer_from_keys(n, spgk, cfg) for a, n in nets.items()}
    groups = trainers["mean"].partition_by_width(e_h, classes)
    e = e_h.shape[1]
    for width, sel in groups:
        full = 2 * len(sel) * bucket
        valid = int(spgk.sizes.cpu().numpy()[e_h[:, sel]].sum())
        say(f"balanced class L={width}: {len(sel)} queries "
            f"({len(sel) / e:.4f} of them); padded slots "
            f"{1 - valid / max(2 * len(sel) * width, 1):.4f} of the class's "
            f"tiles, {1 - valid / max(full, 1):.4f} at the bucket width")
    for aggrs, tr in trainers.items():
        zero_counts()
        sync()
        t0 = time.perf_counter()
        got = tr.predict_balanced(edges, classes)
        sync()
        dt = time.perf_counter() - t0
        if aggrs == "mean":
            launches["balanced_serve"] = counts()
        want = tr.predict(edges)
        err = float((got - want).abs().max())
        same = torch.equal(got, want)
        say(f"predict_balanced ({aggrs}, classes {classes}): {e} queries in "
            f"{dt:.4f} s -> {e / dt:.1f} queries/s; against predict max "
            f"|d| {err:.3e} (tol {BAL_PREDICT_TOL}), bit-equal: {same} "
            f"[{label}]")
        require(err <= BAL_PREDICT_TOL,
                f"predict_balanced ({aggrs}) differs from predict")
    # one class at the bucket width against fit, the same permutations
    n = REF_STEPS * BATCH
    perms = [riffle_permutation(prng.prng_key(40 + ep), REF_STEPS, BATCH,
                                device=DEVICE) for ep in range(2)]
    state = nets["mean"].state_dict()
    out = []
    for balanced in (False, True):
        m = make_net("mean", dropout=0.0, dtype="bfloat16")
        m.load_state_dict(state)
        tr = trainer_from_keys(m, spgk, cfg)
        key = prng.prng_key(5)
        if balanced:
            losses = tr.fit_balanced(edges[:, :n], labels[:n], 2, key,
                                     (bucket,), perms=[[p] for p in perms])[0]
        else:
            losses = tr.fit(edges[:, :n], labels[:n], 2, key, perms=perms)[0]
        out.append((losses.cpu(), {k: v.float().cpu()
                                   for k, v in m.state_dict().items()}))
    (lf, pf), (lb, pb) = out
    err = max(float((pb[k] - pf[k]).abs().max()) for k in pf)
    same = all(torch.equal(pb[k], pf[k]) for k in pf) and torch.equal(lb, lf)
    ok = all(torch.allclose(pb[k], pf[k], rtol=1e-4, atol=1e-6) for k in pf)
    say(f"fit_balanced, one class at L={bucket}, against fit with the same "
        f"permutations (2 epochs x {REF_STEPS} steps): max |d param| "
        f"{err:.3e} (rtol 1e-4, atol 1e-6), bit-equal: {same} "
        f"{'ok' if ok else 'FAIL'}")
    require(ok, "a one-class fit_balanced differs from fit")
    # a balanced and a plain fit in turns
    tr = trainers["mean"]
    key = prng.prng_key(6)
    tr.fit_balanced(edges, labels, 1, key, classes)
    times = {"balanced": [], "plain": []}
    for turn in range(BAL_TURNS):
        for kind in ("plain", "balanced"):
            sync()
            t0 = time.perf_counter()
            if kind == "plain":
                losses = tr.fit(edges, labels, BAL_EPOCHS, key)[0]
            else:
                if turn == 0:
                    zero_counts()
                losses = tr.fit_balanced(edges, labels, BAL_EPOCHS, key,
                                         classes)[0]
            sync()
            times[kind].append(time.perf_counter() - t0)
            if kind == "balanced" and turn == 0:
                launches["balanced_train"] = counts()
            require(bool(torch.isfinite(losses).all()),
                    f"a {kind} fit's loss is not finite")
    med = {k: float(np.median(v)) for k, v in times.items()}
    q = BAL_EPOCHS * e
    say(f"balanced vs plain fit (mean, {BAL_EPOCHS} epochs x {e} queries, "
        f"{BAL_TURNS} turns each, in turns): plain "
        f"{[round(t, 4) for t in times['plain']]} s, median "
        f"{med['plain']:.4f} s -> {q / med['plain']:.1f} queries/s; balanced "
        f"{[round(t, 4) for t in times['balanced']]} s, median "
        f"{med['balanced']:.4f} s -> {q / med['balanced']:.1f} queries/s; "
        f"plain / balanced {med['plain'] / med['balanced']:.3f} [{label}]")
    zero_counts()
    trainers["attn"].fit_balanced(edges, labels, 1, prng.prng_key(7),
                                  classes)
    launches["balanced_attn_train"] = counts()
    nonzero = lambda path: {k: v for k, v in launches[path].items() if v}
    say(f"launches: balanced serving (mean) {nonzero('balanced_serve')}; "
        f"balanced training (mean, one timed fit) "
        f"{nonzero('balanced_train')}; balanced attn epoch "
        f"{nonzero('balanced_attn_train')}")


# ------------------------------------------------------------ host engine
def host_engine_path(dev: SpGDevice, edges, labels, label, launches) -> None:
    """The host engine (`LinkPredictor`) on the encoding-table sets: one
    epoch of the mean Net (float32, as the CLI's host engine) at batch
    4096 over the 32 x 4096 edges, then `evaluate` (MRR of N_SRC sources
    against HOST_NEG negatives each); and beside it the device engine's
    epoch with the same Net and weights. The host engine reads each
    step's loss and predictions back by design: no sync check."""
    e_h, l_h = edges.cpu().numpy(), labels.cpu().numpy()
    cfg = TrainConfig(batch_size=BATCH, lr=LR, grad_clip=GRAD_CLIP)
    net = make_net("mean", dropout=0.1,
                   key=prng.prng_key(0))
    state = {k: v.clone() for k, v in net.state_dict().items()}
    host = LinkPredictor(net, dev, cfg, device=DEVICE)
    host.train_epoch(e_h[:, :BATCH], l_h[:BATCH], np.random.default_rng(1),
                     prng.prng_key(1))
    host.init(prng.prng_key(0))     # the weights of `state`
    zero_counts()
    sync()
    t0 = time.perf_counter()
    loss, auc = host.train_epoch(e_h, l_h, np.random.default_rng(2),
                                 prng.prng_key(3))
    sync()
    dt = time.perf_counter() - t0
    rng = np.random.default_rng(4)
    src = rng.integers(0, dev.nodes.shape[0], N_SRC)
    inf = {split: (np.stack([src, rng.integers(0, dev.nodes.shape[0], N_SRC)]),
                   np.stack([np.repeat(src, HOST_NEG), rng.integers(
                       0, dev.nodes.shape[0], N_SRC * HOST_NEG)]))
           for split in ("valid", "test")}
    t0 = time.perf_counter()
    (_, mrr_v, mrr_t), _ = evaluate(host, inf, "MRR")
    ev = time.perf_counter() - t0
    launches["host_engine"] = counts()
    dnet = make_net("mean", dropout=0.1)
    dnet.load_state_dict(state)
    dtr = DeviceTrainer(dnet, dev, cfg)
    dtr.fit(edges, labels, 1, prng.prng_key(3))
    sync()
    t0 = time.perf_counter()
    dtr.fit(edges, labels, 1, prng.prng_key(4))
    sync()
    ddt = time.perf_counter() - t0
    e = e_h.shape[1]
    preds = 2 * N_SRC * (1 + HOST_NEG)
    say(f"host engine (mean, table, fp32, batch {BATCH}): one epoch of {e} "
        f"queries in {dt:.4f} s -> {e / dt:.1f} queries/s (loss "
        f"{loss:.6f}, exact AUC {auc:.6f}); device engine, the same Net and "
        f"weights: {ddt:.4f} s -> {e / ddt:.1f} queries/s; evaluate (MRR, "
        f"{preds} scores) {ev:.4f} s -> {preds / ev:.1f} scores/s, MRR "
        f"valid {mrr_v:.6f} test {mrr_t:.6f}; launches "
        f"{ {k: v for k, v in launches['host_engine'].items() if v} } "
        f"[{label}]")
    require(math.isfinite(loss) and 0 <= auc <= 1 and 0 < mrr_v <= 1
            and 0 < mrr_t <= 1, "the host engine gave bad values")

# ------------------------------------------------------ the multi-device path
# four ranks share the card over gloo, mesh data 2 x graph 2
MD_RANKS, MD_GRAPH_AXIS, MD_BACKEND = 4, 2, "gloo"
MD_STEPS, MD_SEED = 16, 0               # timed steps; the sampler's seed
MD_TIMEOUT_S = 900
MD_GATHER_REPS = 10
# the MRR's splits: a valid split of MD_VALID_SRC sources, the test split
# N_SRC x (K_NEG + 1) pairs; the scores of MD_CHECK_NEG negatives a source
# held to `predict`
MD_VALID_SRC, MD_CHECK_NEG = 64, 100
# a gradient entry below this is rounding noise; Adam's first step moves
# its parameter by up to lr either way there
MD_NOISE_GRAD = 1e-6
MD_KEYS = ("nodes", "khi", "klo", "sizes")


def md_config() -> dict:
    """The multi-device phase's sizes, written for the ranks: the main
    path's graph, sets, width and batch."""
    return dict(nodes=N_NODES, edges=N_EDGES, walks=NUM_WALKS,
                steps=NUM_STEPS, hidden=HIDDEN, batch=BATCH, timed=MD_STEPS,
                n_src=N_SRC, k_neg=K_NEG, valid_src=MD_VALID_SRC,
                check_neg=MD_CHECK_NEG, graph_axis=MD_GRAPH_AXIS,
                seed=MD_SEED, lr=LR, grad_clip=GRAD_CLIP,
                gather_reps=MD_GATHER_REPS)


def md_same_sets(a: SpGKeys, b: SpGKeys, rows=slice(None)) -> bool:
    """Whether `a`'s rows equal rows `rows` of `b` exactly."""
    return all(torch.equal(getattr(a, k), getattr(b, k)[rows])
               for k in MD_KEYS)


def md_step_state(loss, model, opt) -> tuple:
    """(loss, parameters, Adam's first moment = 0.1 g) after one step, on
    the host."""
    host = lambda t: t.detach().float().cpu()
    return (float(loss),
            {n: host(p) for n, p in model.named_parameters()},
            {n: host(opt.state[p]["exp_avg"])
             for n, p in model.named_parameters()})


def md_compare(dist_state, single_state, loss_rtol, params: bool) -> dict:
    """A distributed step against the single-process one: the loss's
    relative error and, with `params`, the gradients' and parameters'
    worst excess over rtol 1e-4 / atol 1e-5 (parameters whose gradient is
    rounding noise, below MD_NOISE_GRAD, held to 2 lr). ok when none
    exceeds."""
    loss, p, mu = dist_state
    want_loss, want_p, want_mu = single_state
    loss_err = abs(loss - want_loss) / max(abs(want_loss), 1e-30)
    out = dict(loss=loss, single_loss=want_loss, loss_rel_err=loss_err,
               ok=loss_err <= loss_rtol)
    if params:
        worst = 0.0
        for name, w in want_p.items():
            g, wg = mu[name] / 0.1, want_mu[name] / 0.1
            worst = max(worst, float(((g - wg).abs()
                                      - (1e-5 + 1e-4 * wg.abs())).max()))
            noise = wg.abs() < MD_NOISE_GRAD
            tol = torch.where(noise, 2 * LR, 1e-5 + 1e-4 * w.abs())
            worst = max(worst, float(((p[name] - w).abs() - tol).max()))
        out.update(excess=worst, ok=out["ok"] and worst <= 0)
    return out


def multi_device_rank(ctx) -> dict:
    """One rank of the multi-device phase (`parallel.launch.run_ranks`
    calls it): the main path's graph and sets, partitioned sampling over
    every node against `sample_block` over the same seeds and key
    (exactly), the capacity routing and the grouped sampler (group 2)
    against the probe, the rows moved to their graph shards, the row
    gathers (psum against all-to-all), the bf16 mean keys step (a cold
    step, then MD_STEPS timed), the fp32 mean, attn and lstm steps and
    the fp32 HONet step and scorer against rank 0's single-process
    trainer, and the scorer's MRR over N_SRC x (K_NEG + 1) pairs. Returns
    what the parent checks, and the kernels' launch counts of each step
    and of the scoring."""
    from surel_plus_tpu_torch.parallel import dist as pdist
    from surel_plus_tpu_torch.parallel import partition as ppart
    from surel_plus_tpu_torch.parallel.mesh import make_mesh

    cfg = torch.load(os.path.join(ctx.payload_dir, "config.pt"))
    dev = ctx.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(graph_axis=cfg["graph_axis"], device=dev)
    world, lead = mesh.world_size, ctx.rank == 0
    M, S, B, H = cfg["walks"], cfg["steps"], cfg["batch"], cfg["hidden"]
    out = dict(rank=ctx.rank, shape=dict(mesh.shape), device=str(dev),
               launches={}, checks={})

    def wait():
        """The device idle and every rank here."""
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        torch.distributed.barrier()

    def timed(fn):
        wait()
        t0 = time.perf_counter()
        res = fn()
        wait()
        return res, time.perf_counter() - t0

    g = rmat_graph(cfg["nodes"], cfg["edges"], seed=0)
    seeds = np.arange(g.num_nodes, dtype=np.int32)
    n = len(seeds)
    n_pad = -(-n // world) * world
    pcsr = ppart.partition_csr(g, world, seed=cfg["seed"])
    local, out["sample_s"] = timed(lambda: ppart.sample_gsets_partitioned(
        pcsr, seeds, M, S, mesh, seed=cfg["seed"]))
    pad = np.zeros(n_pad, np.int32)
    pad[:n] = seeds
    # the whole padded block from the partitioned sampler's key
    indptr, _ = device_graph(g, dev)
    etab, stab = walk_tables_for(g, cfg["seed"], dev)
    nodes, sizes, khi, klo = walk_ops.sample_block(
        indptr, etab, stab, torch.as_tensor(pad).to(dev), num_walks=M,
        num_steps=S, bucket=M * S + 1, key=prng.prng_key(cfg["seed"]))
    ref = SpGKeys(nodes=nodes, khi=khi, klo=klo, sizes=sizes, num_walks=M,
                  num_steps=S)
    del nodes, sizes, khi, klo, indptr, etab, stab
    rows = slice(local.start, local.start + local.sets.nodes.shape[0])
    out["checks"]["partitioned = sample_block"] = md_same_sets(
        local.sets, ref, rows)
    out["rows"] = local.sets.nodes.shape[0]
    for name, fn in (
            ("capacity routing", lambda: ppart.sample_gsets_partitioned(
                pcsr, seeds, M, S, mesh, seed=cfg["seed"],
                routing="capacity")),
            ("grouped (2)", lambda: ppart.sample_gsets_grouped(
                g, seeds, M, S, mesh, 2, seed=cfg["seed"]))):
        other, out[f"{name} s"] = timed(fn)
        out["checks"][f"{name} = probe"] = md_same_sets(other.sets,
                                                       local.sets)
        del other
    sspg, out["shard_s"] = timed(lambda: pdist.shard_spg_keys(local, mesh))
    rps, gi = sspg.rows_per_shard, mesh.graph_index
    lo, hi = gi * rps, min((gi + 1) * rps, n)
    shard = SpGKeys(nodes=sspg.nodes[:hi - lo], khi=sspg.khi[:hi - lo],
                    klo=sspg.klo[:hi - lo], sizes=sspg.sizes[:hi - lo],
                    num_walks=M, num_steps=S)
    out["checks"]["graph shard = its rows"] = md_same_sets(
        shard, ref, slice(lo, hi))
    del local, shard, pcsr
    if not lead:
        del ref

    rng = np.random.default_rng(0)
    nb = cfg["timed"] + 1
    edges = torch.as_tensor(rng.integers(0, n, size=(2, nb * B))).to(dev)
    labels = torch.as_tensor((rng.random(nb * B) < 0.5).astype(
        np.float32)).to(dev)
    weights = torch.ones(nb * B, device=dev)

    def batch(i):
        return tuple(x[..., i * B:(i + 1) * B] for x in (edges, labels,
                                                         weights))

    d, dp = mesh.data_index, mesh.shape["data"]
    ids = edges[:, d * B // dp:(d + 1) * B // dp].contiguous()
    graph = mesh.axis("graph")
    got = {}
    for kind, fn in (("psum", pdist.dist_gather_rows),
                     ("all-to-all", pdist.dist_gather_rows_a2a)):
        fn(sspg.rows, ids, rps, graph)
        got[kind], dt = timed(lambda: [fn(sspg.rows, ids, rps, graph)
                                       for _ in range(cfg["gather_reps"])])
        got[kind] = got[kind][-1]
        out[f"gather {kind} ms"] = dt / cfg["gather_reps"] * 1e3
    out["checks"]["psum gather = all-to-all gather"] = torch.equal(
        got["psum"], got["all-to-all"])
    if lead:
        whole = torch.cat([ref.nodes, ref.khi, ref.klo, ref.sizes[:, None]],
                          dim=1)
        out["checks"]["gathered rows = the store's"] = torch.equal(
            got["psum"], whole[ids])
        del whole
    del got

    def net(aggrs="mean", dtype="float32", dropout=0.0, cls=Net):
        kw = dict(aggrs=aggrs, dtype=dtype) if cls is Net else {}
        m = cls(S + 1, H, dropout=dropout, key_layout=(M, S),
                key=prng.prng_key(0), device=dev,
                **kw)
        return m, torch.optim.Adam(m.parameters(), lr=cfg["lr"], eps=1e-8)

    # the bf16 mean step at the bench width: a cold step, then timed ones
    m, opt = net(dtype="bfloat16", dropout=0.1)
    step = pdist.DistributedKeysTrainStep(m, opt, mesh, sspg,
                                          grad_clip=cfg["grad_clip"])
    _, out["cold_step_s"] = timed(lambda: float(step(*batch(0),
                                                     prng.prng_key(0))))
    zero_counts()
    losses, dt = timed(lambda: [step(*batch(i), prng.prng_key(i))
                                for i in range(1, nb)])
    out["launches"]["multi_device"] = counts()
    out["step_ms"] = dt / cfg["timed"] * 1e3
    out["queries_per_s"] = cfg["timed"] * B / dt
    out["checks"]["bf16 losses finite"] = bool(torch.isfinite(
        torch.stack(losses)).all())
    del step, m, opt

    cfg_single = TrainConfig(batch_size=B, lr=cfg["lr"],
                             grad_clip=cfg["grad_clip"])
    perm = torch.arange(B, device=dev)[None]

    def single_step(model, be, bl, join_factory=None):
        trainer = trainer_from_keys(model, ref, cfg_single,
                                    join_factory=join_factory)
        loss, _ = trainer.train_epoch(be, bl, prng.prng_key(1), perm=perm)
        return trainer, md_step_state(loss, model, trainer.optimizer)

    kept = {}
    for aggrs, path in (("mean", None), ("attn", "multi_device_attn"),
                        ("lstm", "multi_device_lstm")):
        m, opt = net(aggrs)
        step = pdist.DistributedKeysTrainStep(m, opt, mesh, sspg,
                                              grad_clip=cfg["grad_clip"])
        zero_counts()
        loss = float(step(*batch(0)))
        wait()
        if path:
            out["launches"][path] = counts()
        state = md_step_state(loss, m, opt)
        if lead:
            sm, _ = net(aggrs)
            trainer, want = single_step(sm, *batch(0)[:2])
            out[f"{aggrs} step"] = md_compare(
                state, want, 1e-5 if aggrs == "mean" else 1e-4,
                params=aggrs == "mean")
            if aggrs == "mean":
                kept["trainer"] = trainer
        if aggrs == "mean":
            kept["model"] = m
        del step, opt
        wait()

    # HONet: its step over B hyperedges and its scorer
    hedges = torch.as_tensor(rng.integers(0, n, size=(3, 2 * B))).to(dev)
    hb = (hedges[:, :B], labels[:B], weights[:B])
    honet, hopt = net(cls=HONet)
    hstep = pdist.DistributedKeysHTrainStep(honet, hopt, mesh, sspg,
                                            grad_clip=cfg["grad_clip"])
    zero_counts()
    loss = float(hstep(*hb))
    wait()
    out["launches"]["multi_device_honet"] = counts()
    hstate = md_step_state(loss, honet, hopt)
    hscorer = pdist.DistributedKeysScorer(
        honet, mesh, sspg, batch_size=B, join_gathered=join_gathered_hkeys)
    hscores = hscorer(hedges[:, B:])
    if lead:
        sh, _ = net(cls=HONet)
        trainer, want = single_step(sh, *hb[:2], join_factory=(
            functools.partial(make_keys_hjoin, **sh.join_outputs(dev))))
        out["honet step"] = md_compare(hstate, want, 1e-5, params=True)
        sh.load_state_dict(honet.state_dict())
        err = float((hscores - trainer.predict(hedges[:, B:])).abs().max())
        out["honet scores"] = dict(max_abs_err=err, ok=err <= CPU_TOL)
        del trainer, sh
    del hstep, honet, hopt, hscorer
    wait()

    # the scorer and evaluate_distributed's MRR (fp32 mean, after its step)
    model = kept["model"]
    gen = np.random.default_rng(7)
    k = cfg["k_neg"]

    def split(n_src):
        src = gen.integers(0, n, n_src)
        pos = np.stack([src, gen.integers(0, n, n_src)])
        neg = np.stack([np.repeat(src, k), gen.integers(0, n, n_src * k)])
        return pos, neg

    valid, test = split(cfg["valid_src"]), split(cfg["n_src"])
    scorer = pdist.DistributedKeysScorer(model, mesh, sspg, batch_size=B)
    negs = test[1].reshape(2, -1, k)[:, :, :cfg["check_neg"]]
    check = np.concatenate([test[0], negs.reshape(2, -1)], axis=1)
    scores = scorer(check)
    if lead:
        trainer = kept["trainer"]
        trainer.model.load_state_dict(model.state_dict())
        err = float((scores - trainer.predict(check)).abs().max())
        out["scores"] = dict(max_abs_err=err, ok=err <= CPU_TOL)
        pos_s = trainer.predict(test[0])
        neg_s = trainer.predict(test[1]).reshape(-1, k)
        out["single_mrr"] = float(device_mrr(pos_s, neg_s))
    zero_counts()
    res, t_test = pdist.evaluate_distributed(
        scorer, {"valid": valid, "test": test}, "MRR")
    wait()
    out["launches"]["multi_device_serve"] = counts()
    out["mrr"], out["mrr_s"] = res[2], t_test
    out["pairs_per_s"] = test[0].shape[1] * (k + 1) / t_test
    if dev.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    return out


def multi_device_path(label, launches) -> None:
    """The multi-device phase: MD_RANKS ranks on the one card over gloo
    (`multi_device_rank` in each, through `run_ranks`; a rank that fails
    fails the run), their checks and numbers, the launch counts summed
    over the ranks into `launches`; then the dry run at world 1 over NCCL,
    and over NCCL across cards where the machine has more than one."""
    from surel_plus_tpu_torch.parallel.dryrun import dryrun_multichip
    from surel_plus_tpu_torch.parallel.launch import run_ranks

    gc.collect()
    torch.cuda.empty_cache()
    say(f"multi-device: {MD_RANKS} ranks over {MD_BACKEND} on one card "
        f"(mesh data {MD_RANKS // MD_GRAPH_AXIS} x graph {MD_GRAPH_AXIS}): "
        f"the four ranks share one card's SMs and exchange through host "
        f"memory, so the rates below measure no scaling [{label}]")
    with tempfile.TemporaryDirectory() as payload:
        torch.save(md_config(), os.path.join(payload, "config.pt"))
        t0 = time.perf_counter()
        res = run_ranks("chip_smoke:multi_device_rank", MD_RANKS,
                        MD_BACKEND, DEVICE, payload, MD_TIMEOUT_S)
        wall = time.perf_counter() - t0
    lead = res[0]
    say(f"multi-device: {len(res)} ranks done in {wall:.1f} s (processes "
        f"started, graph, sampling, steps, scoring); mesh {lead['shape']}, "
        f"devices {sorted({r['device'] for r in res})}")
    say(f"multi-device sampling: partitioned (probe, edge tables) "
        f"{N_NODES} sets, M={NUM_WALKS}, S'={NUM_STEPS}, "
        f"{max(r['sample_s'] for r in res):.3f} s -> "
        f"{N_NODES / max(r['sample_s'] for r in res):.1f} sets/s; "
        f"capacity routing {max(r['capacity routing s'] for r in res):.3f} "
        f"s; grouped (2) {max(r['grouped (2) s'] for r in res):.3f} s; "
        f"rows to their graph shards {max(r['shard_s'] for r in res):.3f} "
        f"s [{label}]")
    say(f"multi-device row gathers ([2, {BATCH // 2}] ids a data rank, "
        f"packed rows of {3 * (NUM_WALKS * NUM_STEPS + 1) + 1} int32): "
        f"psum {np.mean([r['gather psum ms'] for r in res]):.3f} ms, "
        f"all-to-all {np.mean([r['gather all-to-all ms'] for r in res]):.3f}"
        f" ms (mean over ranks) [{label}]")
    say(f"multi-device train (Net(96, mean, bf16), batch {BATCH}, "
        f"{BATCH // (MD_RANKS // MD_GRAPH_AXIS)} a data rank): cold step "
        f"{lead['cold_step_s']:.3f} s; {MD_STEPS} steps at "
        + ", ".join(f"rank {r['rank']} {r['step_ms']:.3f} ms/step "
                    f"({r['queries_per_s']:.1f} q/s)" for r in res)
        + f" [{label}]")
    for what in ("mean step", "attn step", "lstm step", "honet step",
                 "honet scores", "scores"):
        say(f"multi-device {what} against the single-process trainer "
            f"(rank 0): {lead[what]}")
    say(f"multi-device MRR: {N_SRC} sources x {K_NEG + 1} candidates, "
        f"evaluate_distributed {lead['mrr']:.6f} (single process "
        f"{lead['single_mrr']:.6f}), test split {lead['mrr_s']:.3f} s -> "
        f"{lead['pairs_per_s']:.1f} pairs/s; peak device memory a rank "
        f"{max(r.get('peak_gib', 0.0) for r in res):.2f} GiB [{label}]")
    for r in res:
        for what, ok in r["checks"].items():
            require(ok, f"multi-device rank {r['rank']}: {what} fails")
    for what in ("mean step", "attn step", "lstm step", "honet step",
                 "honet scores", "scores"):
        require(lead[what]["ok"], f"multi-device {what}: {lead[what]}")
    require(math.isfinite(lead["mrr"]) and 0 < lead["mrr"] <= 1,
            f"multi-device MRR {lead['mrr']} out of range")
    for path in res[0]["launches"]:
        launches[path] = {name: sum(r["launches"][path][name] for r in res)
                          for name in KERNELS}
        say(f"launches on the {path} path (summed over the ranks): "
            f"{launches[path]}")

    t0 = time.perf_counter()
    dryrun_multichip(1, "nccl", DEVICE)
    say(f"dry run over NCCL, world 1: {time.perf_counter() - t0:.1f} s")
    cards = torch.cuda.device_count()
    if cards >= 2:
        t0 = time.perf_counter()
        dryrun_multichip(min(4, cards), "nccl", DEVICE)
        say(f"dry run over NCCL across {min(4, cards)} cards: "
            f"{time.perf_counter() - t0:.1f} s")
    else:
        say("the dry run over NCCL across cards waits for a machine with "
            f"more than one card (this one has {cards})")


def scale_path(label, launches) -> None:
    """The large-graph path's device stages (`scale_demo.run_device`) at
    SCALE, its launches counted as the `scale` path: the walk graph on
    the card in int32 words (32 B a directed edge, plus indptr), the
    sets' invariants, the card's warm sets equal to the CPU port's for
    the first SCALE_CPU_SEEDS seeds (a draw depends only on its flat
    index), finite losses; prints each stage's seconds and peak."""
    gc.collect()
    torch.cuda.empty_cache()
    zero_counts()
    t0 = time.perf_counter()
    res = scale_demo.run_device(**SCALE, device=DEVICE,
                                log=lambda msg: say(f"scale {msg}"))
    launches["scale"] = counts()
    wall = time.perf_counter() - t0
    g, gb, warm = res["graph"], res["graph_bytes"], res["sets"]["warm"]
    say(f"scale: the walk graph on the card {gb['total']:,} B = "
        f"{gb['per_edge']:.2f} B x {g.num_edges:,} directed edges + indptr "
        f"{gb['indptr']:,} B [{label}]")
    require(gb["per_edge"] == 32 and gb["indptr"] == 4 * (g.num_nodes + 1),
            f"scale: the walk graph takes {gb['per_edge']} B a directed "
            f"edge and {gb['indptr']} B of indptr, not int32 words")
    check_sets(warm, torch.arange(SCALE["seeds"], device=DEVICE), cut=True)
    t1 = time.perf_counter()
    cpu = sample_gsets_device_keys(
        g, np.arange(SCALE_CPU_SEEDS), SCALE["walks"], SCALE["steps"],
        seed=1, shuffle_seed=0, bucket=SCALE["bucket"], device="cpu")
    same = all(torch.equal(getattr(warm, k)[:SCALE_CPU_SEEDS].cpu(),
                           getattr(cpu, k)) for k in MD_KEYS)
    require(same, f"scale: the card's sets differ from the CPU's on the "
                  f"first {SCALE_CPU_SEEDS} seeds")
    require(all(bool(torch.isfinite(res[k]).all())
                for k in ("losses_cold", "losses_warm")),
            "scale: a loss is not finite")
    for name, row in res["stages"].items():
        say(f"scale stage {name}: {row['s']:.3f} s, peak device "
            f"{row['peak_gb']:.3f} GB, live {row['live_gb']:.3f} GB, host "
            f"RSS {row['rss_gb']:.2f} GB")
    say(f"scale: warm sampling {res['sets_per_s']:.1f} sets/s, training "
        f"{res['queries_per_s']:.1f} q/s; the phase {wall:.1f} s (the CPU's "
        f"sets {time.perf_counter() - t1:.1f} s) [{label}]")
    say(f"launches on the scale path: {launches['scale']}")
    del res, g, warm, cpu
    gc.collect()
    torch.cuda.empty_cache()


def counts():
    return {name: k["kernel"].launches for name, k in KERNELS.items()}


def zero_counts() -> None:
    for k in KERNELS.values():
        k["kernel"].launches = 0


def main() -> int:
    start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    label = card_label()
    say(f"card: {label}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # phase 1: build
    t0 = time.perf_counter()
    logs = build.build_all(sorted({k["kernel"].source
                                   for k in KERNELS.values()}))
    say(f"build: {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(s) for s in re.findall(r"(\d+) bytes spill", log))
        say(f"  ptxas {name}: {len(regs)} entries, at most {max(regs)} "
            f"registers, {spills} bytes spilled")
    for name in ("hidden_sum", "hidden_sum_bwd", "hidden_slots_bwd"):
        for line in logs.get(name, "").splitlines():
            if re.search(r"Compiling entry|Used \d+ registers|spill", line):
                say(f"  {name}: {line.strip()}")

    t0 = time.perf_counter()
    g = rmat_graph(N_NODES, N_EDGES, seed=0)
    say(f"graph: N={g.num_nodes} E={g.num_edges} (host, "
        f"{time.perf_counter() - t0:.2f} s)")

    # phase 2: every kernel against its plain version on the card
    gsets = general_sets(g)
    stats = kernels_vs_plain(g, gsets)

    # phase 3: the main paths, counting launches
    launches = {}
    init_from_key(label, launches)
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    spgk, net, edges = serve_path(g, label)
    launches["serve"] = counts()
    say(f"launches on the serving path: {launches['serve']}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check_routes(spgk, net, edges)
    profile_predict(spgk, net, edges)

    trainer, tedges, tlabels, tkey = train_setup(spgk, "mean")
    check_train_routes(spgk, trainer.model, tedges, tlabels)
    fit_cold(trainer, tedges, tlabels, tkey, N_EPOCHS)
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    fit_timed(trainer, tedges, tlabels, tkey, N_EPOCHS, label)
    launches["train"] = counts()
    say(f"launches on the training path (timed fit): {launches['train']}; "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check_train_cpu(spgk, trainer.model, tedges, tlabels)
    profile_train(trainer, tedges, tlabels, tkey)

    # the attention path (bench.py:203-234), on the same sets and edges
    atrainer, _, _, akey = train_setup(spgk, "attn")
    zero_counts()
    timed_predict(atrainer, tedges, label, "attn")
    launches["attn_serve"] = counts()
    say(f"launches on the attention serving path: "
        f"{launches['attn_serve']}")
    check_routes(spgk, atrainer.model, tedges)
    check_train_routes(spgk, atrainer.model, tedges, tlabels)
    fit_cold(atrainer, tedges, tlabels, akey, ATTN_EPOCHS)
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    fit_timed(atrainer, tedges, tlabels, akey, ATTN_EPOCHS, label)
    launches["attn_train"] = counts()
    say(f"launches on the attention training path (timed fit): "
        f"{launches['attn_train']}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    timed_predict(atrainer, tedges, label, "attn, after the fit")
    check_train_cpu(spgk, atrainer.model, tedges, tlabels)
    profile_predict(spgk, atrainer.model, tedges)
    profile_train(atrainer, tedges, tlabels, akey)

    # the LSTM paths (bench.py:206-231), on the same sets and edges
    ltrainer, _, _, lkey = train_setup(spgk, "lstm")
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    lstm_serve(ltrainer, tedges, label)
    launches["lstm_serve"] = counts()
    say(f"launches on the LSTM serving path: {launches['lstm_serve']}; "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check_routes(spgk, ltrainer.model, tedges)
    check_train_routes(spgk, ltrainer.model, tedges, tlabels)
    fit_cold(ltrainer, tedges, tlabels, lkey, LSTM_EPOCHS)
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    fit_timed(ltrainer, tedges, tlabels, lkey, LSTM_EPOCHS, label)
    launches["lstm_train"] = counts()
    say(f"launches on the LSTM training path (timed fit): "
        f"{launches['lstm_train']}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    timed_predict(ltrainer, tedges, label, "lstm, after the fit")
    check_train_cpu(spgk, ltrainer.model, tedges, tlabels)
    profile_predict(spgk, ltrainer.model, tedges)
    profile_train(ltrainer, tedges, tlabels, lkey)

    # the encoding-table path, on the same graph, sets and edges, then the
    # host engine on its sets
    tdev = table_path(g, spgk, tedges, tlabels, label, launches)
    host_engine_path(tdev, tedges, tlabels, label, launches)
    del tdev
    # the keys join's impl "pallas", on the same sets and edges
    keys_pallas_path(spgk, tedges, label, launches, gsets)
    # the unfused keys routes (K7, K7 bwd), on the same sets and edges
    unfused_path(spgk, tedges, tlabels, label, launches)
    # the lstm Net on wide sets: its stash whole at L=801, in row groups in
    # the general layout
    spw, _, _ = joined_batch(g, WIDE_WALKS, WIDE_STEPS, seed=12)
    wide_lstm_fits(spw, gsets, label)
    # HONet, the hyperedge path, on the main path's sets, then at the
    # tags-math class shape on the wide sets
    honet_path(spgk, spw, label, launches)
    del spw
    # the scalar encoders' path, the device PPR, balanced batching
    scalar_path(g, label, launches)
    ppr_device_check(g, label)
    balanced_path(spgk, tedges, tlabels, label, launches)
    with tempfile.TemporaryDirectory() as log_root:
        # the link-prediction CLI on the committed fixtures, then its
        # checkpoints: a resumed and an inference-only run, and the
        # higher-order CLI's best checkpoint
        straight = cli_path(label, launches, log_root)
        cli_resume_path(label, launches, straight, log_root)
        # the higher-order CLI on the tags fixture
        cli_horder_path(label, launches)
        # relation prediction: MAG(P-P) at the paper's settings
        cli_mag_path(label, launches, log_root)
    # the legacy walk API
    legacy_path(g, label)
    # the multi-device path: four ranks on the card, then the dry runs
    multi_device_path(label, launches)
    # the large-graph path at a cut graph
    scale_path(label, launches)

    # phase 4
    for path, names in PATHS.items():
        for name in names:
            require(launches[path][name] > 0,
                    f"kernel {name} never launched on the {path} path")
    rows = []
    for name, k in KERNELS.items():
        st = stats[name]
        rows.append(dict(
            name=name, route="cuda", source=k["source"],
            replaces=k["replaces"],
            launches=launches[MAIN_PATH[name]][name],
            launches_by_path={path: launches[path][name]
                              for path, names in PATHS.items()
                              if name in names},
            max_abs_err=st["max_abs_err"], ms=st["ms"],
            plain_ms=st["plain_ms"], bound_ms=st["bound"][0],
            bound_by=st["bound"][1], library_ms=st["library_ms"]))
    say(json.dumps({"kernels": rows}))
    say(f"total: {time.perf_counter() - start:.1f} s")
    say(label)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
