"""The functions the port's multi-rank tests run in each rank
(`surel_plus_tpu_torch.parallel.launch.run_ranks` calls them with a
RankContext). They import neither JAX nor the JAX package: the test
process computes JAX's references and writes the inputs to the payload
directory (`inputs.pt`, numpy arrays and torch state dicts); each rank
reads them, runs the port's distributed code and returns plain numpy
results.

Run as a script, this module is the worker of the two-process
`init_distributed` test: `python _torch_port_ranks.py ADDRESS WORLD RANK
OUT`.
"""

import os
import sys

import numpy as np
import torch

from surel_plus_tpu_torch.graph import rmat_graph
from surel_plus_tpu_torch.models import HONet, Net
from surel_plus_tpu_torch.ops import prng
from surel_plus_tpu_torch.ops import walk as walk_ops
from surel_plus_tpu_torch.ops.join import join_gathered_hkeys
from surel_plus_tpu_torch.ops.sampler import device_graph, walk_tables_for
from surel_plus_tpu_torch.parallel import dist as pdist
from surel_plus_tpu_torch.parallel import partition as ppart
from surel_plus_tpu_torch.parallel.mesh import make_mesh
from surel_plus_tpu_torch.spg import SpG, SpGKeys


def assert_step(got, want, what, loss_rtol, lr, noise_grad=1e-6):
    """A port step (loss, parameters, Adam's first moment mu, numpy by
    name) against JAX's (loss, parameters, mu): the loss at `loss_rtol`;
    the gradients (mu / 0.1: both optimizers keep mu = 0.1 g after one
    step) at rtol 1e-4 / atol 1e-6; the parameters at rtol 1e-4 /
    atol 1e-6 where JAX's gradient is at least `noise_grad`, else within
    2 lr (Adam's first step on rounding noise goes lr either way)."""
    loss, params, mu = got
    want_loss, want_params, want_mu = want
    assert np.isclose(loss, want_loss, rtol=loss_rtol), (what, loss,
                                                        want_loss)
    assert set(params) == set(want_params) == set(mu), what
    for name, w in want_params.items():
        grad, want_grad = mu[name] / 0.1, np.asarray(want_mu[name]) / 0.1
        np.testing.assert_allclose(grad, want_grad, rtol=1e-4, atol=1e-6,
                                   err_msg=f"{what}: gradient of {name}")
        noise = np.abs(want_grad) < noise_grad
        w = np.asarray(w)
        np.testing.assert_allclose(params[name][~noise], w[~noise],
                                   rtol=1e-4, atol=1e-6,
                                   err_msg=f"{what}: {name}")
        np.testing.assert_allclose(params[name][noise], w[noise], rtol=0,
                                   atol=2 * lr, err_msg=f"{what}: {name}")


def _inputs(ctx):
    return torch.load(os.path.join(ctx.payload_dir, "inputs.pt"),
                      weights_only=False)


def _keys(d) -> SpGKeys:
    t = lambda k: torch.as_tensor(d[k])
    return SpGKeys(nodes=t("nodes"), khi=t("khi"), klo=t("klo"),
                   sizes=t("sizes"), num_walks=int(d["num_walks"]),
                   num_steps=int(d["num_steps"]))


def _np_sets(s: SpGKeys):
    return {k: getattr(s, k).cpu().numpy()
            for k in ("nodes", "khi", "klo", "sizes")}


def _state(model):
    return {k: v.detach().cpu().numpy().copy()
            for k, v in model.state_dict().items()}


def _stepped(loss, model, opt):
    """(loss, parameters, Adam's first moment by parameter name) after a
    step."""
    mu = {n: opt.state[p]["exp_avg"].detach().cpu().numpy().copy()
          for n, p in model.named_parameters()}
    return float(loss), _state(model), mu


def _model(cls, state, dev, lr=1e-2, **kw):
    """A model with the given weights on `dev`, and its Adam (optax's
    eps)."""
    m = cls(key=None, device=dev, **kw)
    m.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    return m, torch.optim.Adam(m.parameters(), lr=lr, eps=1e-8)


def dist_cases(ctx):
    """Every dist.py path on the meshes (4,1), (2,2), (1,4): the row
    gathers, the keys steps (mean on both routes, attn, lstm), the table
    step, the HONet step, the scorers and their metrics, and the
    seed-sharded sampler."""
    inp = _inputs(ctx)
    dev = ctx.device
    spgk = _keys(inp["spgk"])
    nw, ns = spgk.num_walks, spgk.num_steps
    t = inp["table"]
    spg = SpG(nodes=t["nodes"], eidx=t["eidx"], sizes=t["sizes"],
              enc=t["enc"], seeds=t["seeds"], num_walks=nw, num_steps=ns)
    g = rmat_graph(*inp["graph"])
    out = {}
    for gp in inp["graph_axes"]:
        mesh = make_mesh(graph_axis=gp, device=dev)
        res = out[gp] = {"shape": dict(mesh.shape)}
        sspg = pdist.shard_spg_keys(spgk, mesh)
        ids = torch.as_tensor(inp["ids"])
        graph = mesh.axis("graph")
        rps = sspg.rows_per_shard
        res["gather_psum"] = [pdist.dist_gather_rows(
            x, ids, rps, graph).numpy() for x in (sspg.nodes, sspg.klo)]
        res["gather_a2a"] = [pdist.dist_gather_rows_a2a(
            x, ids, rps, graph).numpy() for x in (sspg.nodes, sspg.klo)]
        batch = (inp["edges"], inp["labels"], inp["weights"])
        for case, (aggrs, fused) in inp["key_cases"].items():
            model, opt = _model(Net, inp["params"][aggrs], dev, input_dim=3,
                                hidden_dim=inp["hidden"], aggrs=aggrs,
                                dropout=0.0, key_layout=(nw, ns),
                                fused_hidden=fused)
            step = pdist.DistributedKeysTrainStep(model, opt, mesh, sspg,
                                                  grad_clip=1.0)
            res[case] = _stepped(step(*batch), model, opt)
        model, opt = _model(Net, inp["params"]["table"], dev, input_dim=3,
                            hidden_dim=inp["hidden"], aggrs="mean",
                            dropout=0.0)
        step = pdist.DistributedTrainStep(model, opt, mesh,
                                          pdist.shard_spg(spg, mesh),
                                          grad_clip=1.0)
        res["table"] = _stepped(step(*batch), model, opt)
        model, opt = _model(HONet, inp["params"]["honet"], dev, input_dim=3,
                            hidden_dim=inp["hidden"], dropout=0.0,
                            key_layout=(nw, ns))
        step = pdist.DistributedKeysHTrainStep(model, opt, mesh, sspg,
                                               grad_clip=1.0)
        res["honet"] = _stepped(step(inp["hedges"], inp["labels"],
                                     inp["weights"]), model, opt)

        model, _ = _model(Net, inp["params"]["mean"], dev, input_dim=3,
                          hidden_dim=inp["hidden"], aggrs="mean",
                          dropout=0.0, key_layout=(nw, ns))
        scorer = pdist.DistributedKeysScorer(model, mesh, sspg,
                                             batch_size=64)
        res["scores"] = scorer(inp["score_edges"]).numpy()
        for metric in ("Hits@50", "MRR", "AUC"):
            res[metric] = pdist.evaluate_distributed(
                scorer, inp["inf_edge"], metric)[0]
        model, _ = _model(HONet, inp["params"]["honet"], dev, input_dim=3,
                          hidden_dim=inp["hidden"], dropout=0.0,
                          key_layout=(nw, ns))
        hscorer = pdist.DistributedKeysScorer(
            model, mesh, sspg, batch_size=32,
            join_gathered=join_gathered_hkeys)
        res["hscores"] = hscorer(inp["score_hedges"]).numpy()
        res["hMRR"] = pdist.evaluate_distributed(
            hscorer, inp["hinf_edge"], "MRR")[0]

        local = pdist.sample_gsets_sharded(g, inp["seeds"], nw, ns, mesh,
                                           seed=3)
        res["sharded"] = (local.start, local.num_rows, _np_sets(local.sets))
        # the same rank's block through sample_block, from the JAX
        # package's rank key fold_in(PRNGKey(3), rank)
        per = -(-len(inp["seeds"]) // mesh.world_size)
        block = np.zeros(per, np.int32)
        mine = inp["seeds"][ctx.rank * per:(ctx.rank + 1) * per]
        block[:len(mine)] = mine
        indptr, _ = device_graph(g, dev)
        etab, stab = walk_tables_for(g, 3, dev)
        key = prng.fold_in(prng.prng_key(3), ctx.rank)
        res["sharded_ref"] = [x[:len(mine)].numpy() for x in
                              walk_ops.sample_block(
                                  indptr, etab, stab, torch.as_tensor(block),
                                  num_walks=nw, num_steps=ns,
                                  bucket=nw * ns + 1, key=key)]
        res["sharded_rows"] = _np_sets(_rows_of(
            pdist.shard_spg_keys(local, mesh)))
    return out


def _rows_of(s: pdist.ShardedSpGKeys) -> SpGKeys:
    return SpGKeys(nodes=s.nodes, khi=s.khi, klo=s.klo, sizes=s.sizes,
                   num_walks=s.num_walks, num_steps=s.num_steps)


def partition_cases(ctx):
    """The partitioned samplers in every configuration the tests hold to
    JAX: given JAX's bits, both routings over the edge tables and the
    bare exchange, a forced overflow, the grouped sampler (group 1, 2,
    4); unfed (the port's own draw of JAX's bits); and the partitioned sets
    through shard_spg_keys into a keys step."""
    inp = _inputs(ctx)
    dev = ctx.device
    g = rmat_graph(*inp["graph"])
    seeds = inp["seeds"]
    M, S, seed = inp["M"], inp["S"], inp["seed"]
    bits = torch.as_tensor(inp["bits"])
    mesh = make_mesh(device=dev)
    out = {"shards": {}, "grouped": {}}
    for tables in (True, False):
        pcsr = ppart.partition_csr(g, mesh.world_size, seed=seed,
                                   edge_tables=tables)
        for routing, slack in (("probe", 1.25), ("capacity", 1.25),
                               ("capacity", 0.05)):
            local = ppart.sample_gsets_partitioned(
                pcsr, seeds, M, S, mesh, seed=seed, routing=routing,
                capacity_slack=slack, bits=bits)
            out["shards"][tables, routing, slack] = (local.start,
                                                    _np_sets(local.sets))
    for k in (1, 2, 4):
        local = ppart.sample_gsets_grouped(g, seeds, M, S, mesh, k,
                                           seed=seed, bits=bits)
        out["grouped"][k] = (local.start, _np_sets(local.sets))
    pcsr = ppart.partition_csr(g, mesh.world_size, seed=seed)
    local = ppart.sample_gsets_partitioned(pcsr, seeds, M, S, mesh,
                                           seed=seed)
    out["unfed"] = (local.start, _np_sets(local.sets))
    # JAX's sets (JAX's bits) through the exchange into the step
    local = ppart.sample_gsets_partitioned(pcsr, seeds, M, S, mesh,
                                           seed=seed, bits=bits)
    sspg = pdist.shard_spg_keys(local, mesh)
    out["sharded_rows"] = _np_sets(_rows_of(sspg))
    model, opt = _model(Net, inp["params"], dev, lr=inp["lr"],
                        input_dim=S + 1, hidden_dim=inp["hidden"],
                        aggrs="mean", dropout=0.0, key_layout=(M, S))
    step = pdist.DistributedKeysTrainStep(model, opt, mesh, sspg)
    out["step"] = _stepped(step(inp["edges"], inp["labels"],
                                inp["weights"]), model, opt)
    return out


def fails(ctx):
    """A rank that fails: rank 1 raises, the others wait in a collective
    that never completes."""
    if ctx.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    torch.distributed.barrier()
    return ctx.rank


def echo(ctx):
    """Each rank's coordinates and a sum over the world."""
    t = torch.tensor([ctx.rank + 1], device=ctx.device)
    torch.distributed.all_reduce(t)
    return (ctx.rank, ctx.world_size, ctx.backend, str(ctx.device),
            int(t.item()))


def _tcp_worker(address, world, rank, out):
    """The two-process init_distributed test's worker: join over tcp://,
    then partitioned sampling and one keys step over the world; writes
    its rows and loss to `out`."""
    dev = ppart.init_distributed(address, world, rank, device="cpu")
    inp = torch.load(os.path.join(os.path.dirname(out), "inputs.pt"),
                     weights_only=False)
    g = rmat_graph(*inp["graph"])
    mesh = make_mesh(device=dev)
    M, S, seed = inp["M"], inp["S"], inp["seed"]
    pcsr = ppart.partition_csr(g, world, seed=seed)
    local = ppart.sample_gsets_partitioned(
        pcsr, inp["seeds"], M, S, mesh, seed=seed,
        bits=torch.as_tensor(inp["bits"]))
    sspg = pdist.shard_spg_keys(local, mesh)
    model, opt = _model(Net, inp["params"], dev, lr=inp["lr"],
                        input_dim=S + 1, hidden_dim=inp["hidden"],
                        aggrs="mean", dropout=0.0, key_layout=(M, S))
    step = pdist.DistributedKeysTrainStep(model, opt, mesh, sspg)
    loss = float(step(inp["edges"], inp["labels"], inp["weights"]))
    torch.save({"start": local.start, "sets": _np_sets(local.sets),
                "loss": loss, "world": torch.distributed.get_world_size()},
               out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    torch.set_num_threads(1)
    _tcp_worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                sys.argv[4])
