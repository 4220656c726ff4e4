"""PyTorch port, checkpoints (`utils/checkpoint.py`) and the CLIs'
`--resume`, `--inf_only --load_model` and `--use_pretrain`:

- save and load round-trip every field of the CLI's state: the Net's
  parameters, Adam's state, the epoch, the epoch key (JAX's two uint32
  words) and the numpy generator's state; a file holding another object
  is refused (`weights_only`);
- a resumed run is exact: a straight 4-epoch run (`--eval_steps 2`,
  dropout 0.1) writes `latest_0` at epoch 2, and a `--resume latest_0`
  run of the same configuration ends with parameters, Adam's state and
  the last epoch's loss and AUC bitwise equal, on the device engine, on
  the host engine and on the device engine over the DEG sets; its key
  is the one the JAX CLI holds at that point (PRNGKey(seed + 1000)
  split once a block);
- `--inf_only --load_model latest_0` gives the straight run's epoch-2
  evaluation exactly;
- the early-stop checkpoint `{stamp}_0` of both CLIs (as the JAX
  package's tests/test_cli.py:119-143), and `main_horder --inf_only`
  over it giving the run's evaluation at that epoch exactly;
- a checkpoint the JAX CLI wrote (device engine on the CPU, synth-collab)
  read with orbax, its parameters turned by `params_from_flax`: the
  port's `evaluate_device` over JAX's sets gives the JAX run's
  evaluation at that epoch within 1e-4 (both Nets in float32), and its
  key resumes in the port: the port's next epoch draws the batch order
  JAX's next epoch draws;
- `--use_pretrain` feeds the trainer the matrix the JAX CLI feeds its
  own, from a `pretrain_embedding.pt` in the working directory.
"""

import contextlib
import dataclasses
import glob
import math
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surel_plus_tpu.cli import main as jcli
from surel_plus_tpu.graph.datasets import LinkPropDataset as JaxDataset
from surel_plus_tpu.graph.splits import get_pos_neg_edges as jax_splits
from surel_plus_tpu.models import Net as JaxNet
from surel_plus_tpu.ops import sampler as jsampler
from surel_plus_tpu.train import device as jdevice
from surel_plus_tpu.utils import checkpoint as jcheckpoint
from surel_plus_tpu.utils import config as jconfig
from surel_plus_tpu.utils.seeding import set_random_seed as jax_seed
from surel_plus_tpu_torch.cli import main as cli
from surel_plus_tpu_torch.cli import main_horder
from surel_plus_tpu_torch.convert import params_from_flax
from surel_plus_tpu_torch.models import Net
from surel_plus_tpu_torch.ops import prng
from surel_plus_tpu_torch.spg import SpGKeys
from surel_plus_tpu_torch.train import LinkPredictor, TrainConfig
from surel_plus_tpu_torch.train import device as tdevice
from surel_plus_tpu_torch.train.device import (
    DeviceTrainer,
    evaluate_device,
    new_optimizer,
    riffle_permutation,
    trainer_from_keys,
)
from surel_plus_tpu_torch.utils import config as tconfig
from surel_plus_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOY = dict(dataset="synth-collab", synth_nodes=300, synth_edges=1500,
           num_walks=8, num_steps=3, batch_size=128, epochs=4,
           eval_steps=2, runs=1, hidden_channels=16, dropout=0.1,
           early_stop=-1, engine="device")
# the straight run's cases: both engines, and the scalar sets
CASES = {"device": {}, "host": dict(engine="host"),
         "device_deg": dict(sencoder="DEG", topk=20)}


def _cfg(pkg, log_dir, **kw):
    return pkg.apply_dataset_overrides(pkg.ExperimentConfig(
        log_dir=str(log_dir), **{**TOY, **kw}))


@contextlib.contextmanager
def _epoch_results():
    """Records each epoch's (loss, AUC) as the trainers return them."""
    seen = []
    fit, epoch = DeviceTrainer.fit, LinkPredictor.train_epoch

    def spy_fit(self, *a, **kw):
        losses, aucs = fit(self, *a, **kw)
        seen.extend(zip(losses.tolist(), aucs.tolist()))
        return losses, aucs

    def spy_epoch(self, *a, **kw):
        out = epoch(self, *a, **kw)
        seen.append(tuple(out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DeviceTrainer, "fit", spy_fit)
        mp.setattr(LinkPredictor, "train_epoch", spy_epoch)
        yield seen


def _snapshot(trainer):
    clone = lambda d: {k: v.clone() if torch.is_tensor(v) else v
                       for k, v in d.items()}
    opt = trainer.optimizer.state_dict()
    return (clone(trainer.model.state_dict()),
            {i: clone(s) for i, s in opt["state"].items()})


def _assert_bitwise(got, want):
    (gp, go), (wp, wo) = got, want
    assert sorted(gp) == sorted(wp)
    for k in wp:
        assert torch.equal(gp[k], wp[k]), k
    assert sorted(go) == sorted(wo)
    for i in wo:
        for k in wo[i]:
            assert torch.equal(go[i][k], wo[i][k]), (i, k)


def _eval_at(rlog, index):
    """The run's evaluation number `index` in `evaluate`'s form."""
    if isinstance(rlog.results, dict):
        return {k: v[0][index] for k, v in rlog.results.items()}
    return rlog.results[0][index]


@pytest.fixture(scope="module", params=list(CASES))
def straight(request, tmp_path_factory):
    """A straight run of each case: its config, output, epoch results and
    final state."""
    cfg = _cfg(tconfig, tmp_path_factory.mktemp(request.param),
               **CASES[request.param])
    with _epoch_results() as seen:
        out = cli.run_experiment(cfg, device="cpu")
    return cfg, out, seen, _snapshot(out["trainer"])


def test_round_trip_keeps_every_field(tmp_path):
    net = Net(3, 16, dropout=0.1, key=prng.prng_key(0), device="cpu")
    opt = new_optimizer(net, TrainConfig())
    sum((p * p).sum() for p in net.parameters()).backward()
    opt.step()
    key = prng.split(prng.prng_key(1005))[0]
    rng = np.random.default_rng(7)
    rng.permutation(9)
    state = {"params": net.state_dict(), "opt_state": opt.state_dict(),
             "epoch": 2, "key": torch.from_numpy(prng.key_words(key)),
             "rng": rng.bit_generator.state}
    path = save_checkpoint(state, str(tmp_path / "model" / "latest_0"))
    assert path == str(tmp_path / "model" / "latest_0")
    got = load_checkpoint(path)
    assert sorted(got) == sorted(state) and got["epoch"] == 2
    for k, v in state["params"].items():
        assert torch.equal(got["params"][k], v)
    opt2 = new_optimizer(net, TrainConfig())
    opt2.load_state_dict(got["opt_state"])
    for p in net.parameters():
        for k, v in opt.state[p].items():
            assert torch.equal(opt2.state[p][k], v)
    assert got["key"].dtype == torch.uint32
    assert prng.as_key(got["key"]) == key and max(key) >= 1 << 31
    rng2 = np.random.default_rng()
    rng2.bit_generator.state = got["rng"]
    assert rng2.integers(1 << 40) == rng.integers(1 << 40)
    # no module, closure or other object is unpickled
    torch.save({"epoch": 1, "obj": _Opaque()}, tmp_path / "other")
    with pytest.raises(pickle.UnpicklingError):
        load_checkpoint(str(tmp_path / "other"))


class _Opaque:
    pass


def test_resume_is_exact(straight):
    cfg, out, seen, final = straight
    path = f"{cfg.log_dir}/{cfg.dataset}/model/latest_0"
    state = load_checkpoint(path)
    assert state["epoch"] == 2
    # the JAX CLI's key after its two blocks (epoch 0, epochs 1-2)
    want = jax.random.PRNGKey(cfg.seed + 1000)
    for _ in range(2):
        want = jax.random.split(want)[0]
    np.testing.assert_array_equal(state["key"].numpy(), np.asarray(want))
    with _epoch_results() as resumed_seen:
        resumed = cli.run_experiment(dataclasses.replace(cfg, resume=path),
                                     device="cpu")
    assert len(seen) == 4 and len(resumed_seen) == 1
    assert resumed_seen[0] == seen[-1]          # loss and AUC, bitwise
    _assert_bitwise(_snapshot(resumed["trainer"]), final)
    assert resumed["best"] == [None]            # no evaluation after 3


def test_inf_only_equals_the_straight_evaluation(straight):
    cfg, out, _, _ = straight
    path = f"{cfg.log_dir}/{cfg.dataset}/model/latest_0"
    got = cli.run_experiment(
        dataclasses.replace(cfg, inf_only=True, load_model=path),
        device="cpu")
    assert sorted(got) == ["results"]
    assert got["results"] == _eval_at(out["results"], 1)   # epoch 2


def test_early_stop_checkpoint(tmp_path):
    # Hits@50 over fewer than 50 negatives saturates at 1: the second
    # evaluation stops the run
    cfg = _cfg(tconfig, tmp_path, epochs=6, eval_steps=1, early_stop=1,
               synth_nodes=120, synth_edges=400)
    out = cli.run_experiment(cfg, device="cpu")
    evals = out["results"].results[cfg.metric][0]
    assert len(evals) < cfg.epochs
    stops = [p for p in glob.glob(f"{tmp_path}/{cfg.dataset}/model/*_0")
             if not p.endswith("latest_0")]
    assert len(stops) == 1
    state = load_checkpoint(stops[0])
    assert sorted(state) == ["epoch", "params"]
    assert state["epoch"] == len(evals) - 1
    for k, v in out["trainer"].model.state_dict().items():
        assert torch.equal(state["params"][k], v)


def test_horder_checkpoint_and_inf_only(tmp_path):
    cfg = tconfig.ExperimentConfig(
        dataset="synth-tags", synth_nodes=150, synth_edges=500, num_walks=8,
        num_steps=3, batch_size=128, epochs=8, eval_steps=1, early_stop=1,
        runs=1, hidden_channels=16, log_dir=str(tmp_path), k=5,
        engine="device")
    out = main_horder.run_experiment(cfg, device="cpu")
    evals = out["results"].results[0]
    assert len(evals) < cfg.epochs
    (path,) = glob.glob(f"{tmp_path}/synth-tags/model/*_0")
    assert load_checkpoint(path)["epoch"] == len(evals) - 1
    got = main_horder.run_experiment(
        dataclasses.replace(cfg, inf_only=True, load_model=path),
        device="cpu")
    assert got["results"] == evals[-1]


def test_jax_written_checkpoint(tmp_path, monkeypatch):
    # both sides score in float32: in bfloat16 the two packages' roundings
    # tie and untie scores at other places, which moves Hits@K by whole
    # ranks (1 / #positives) for reasons that are not the checkpoint's
    monkeypatch.setattr(jcli, "Net", lambda **kw: JaxNet(**{
        **kw, "dtype": "float32"}))
    kw = dict(epochs=2, eval_steps=1, engine="device", dropout=0.0)
    jcfg = _cfg(jconfig, tmp_path, **kw)
    jout = jcli.run_experiment(jcfg)
    path = f"{tmp_path}/{jcfg.dataset}/model/latest_0"
    state = jcheckpoint.load_checkpoint(path)
    assert int(state["epoch"]) == 1
    want = _eval_at(jout["results"], 1)

    # JAX's data prep and JAX's sets of the inference graph
    rng = jax_seed(jcfg.seed)
    raw = jcli.load_raw(jcfg)
    ds = JaxDataset(raw, mask_ratio=jcfg.train_ratio, k=jcfg.k,
                    use_weight=jcfg.use_weight,
                    use_coalesce=jcfg.use_weight, use_feature=jcfg.use_raw,
                    use_val=jcfg.use_val, rng=rng)
    g_inf = ds.process()["test"]
    inf = {s: jax_splits(s, raw.split_edge, raw.edge_index, ds.num_nodes,
                         rng=rng) for s in ("valid", "test")}
    keys = jsampler.subg_matrix_device_keys(
        g_inf, np.arange(g_inf.num_nodes, dtype=np.int32),
        num_walks=jcfg.num_walks, num_steps=jcfg.num_steps, seed=jcfg.seed)
    c = lambda x: torch.as_tensor(np.array(x).view(np.int32))
    tkeys = SpGKeys(nodes=c(keys.nodes), khi=c(keys.khi), klo=c(keys.klo),
                    sizes=c(keys.sizes), num_walks=keys.num_walks,
                    num_steps=keys.num_steps)
    net = Net(jcfg.num_steps, jcfg.hidden_channels, dropout=0.0,
              key=prng.prng_key(0), device="cpu")
    net.load_state_dict(params_from_flax(jax.tree.map(np.asarray,
                                                      state["params"])))
    scorer = trainer_from_keys(net, tkeys,
                               TrainConfig(batch_size=jcfg.batch_size))
    inf_t = {s: tuple(torch.as_tensor(e, dtype=torch.int64) for e in pair)
             for s, pair in inf.items()}
    got, _ = evaluate_device(scorer, inf_t, jcfg.metric)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k][0] == 0
        for i in (1, 2):
            assert abs(got[k][i] - w[i]) <= 1e-4, (k, i, got[k], w)

    # the checkpoint's key resumes in the port: JAX's next block would
    # fit one epoch from split(key)[1], and the port's fit from the same
    # words draws the same batch order
    jsub = jax.random.split(jnp.asarray(state["key"], jnp.uint32))[1]
    kperm = jax.random.split(jax.random.split(jsub, 1)[0])[0]
    n_edges, bs = 300, jcfg.batch_size
    want_perm = np.asarray(jdevice.riffle_permutation(
        kperm, -(-n_edges // bs), bs))
    drawn = []

    def spy(*a, **kw):
        drawn.append(riffle_permutation(*a, **kw))
        return drawn[-1]

    monkeypatch.setattr(tdevice, "riffle_permutation", spy)
    _, sub = prng.split(prng.as_key(state["key"]))
    edges = np.random.default_rng(3).integers(
        0, g_inf.num_nodes, size=(2, n_edges))
    scorer.fit(edges, np.ones(n_edges, np.float32), 1, sub)
    assert len(drawn) == 1
    np.testing.assert_array_equal(drawn[0].numpy(), want_perm)


class _Captured(Exception):
    pass


def test_use_pretrain_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    kw = dict(use_raw=True, use_pretrain=True, engine="device", epochs=1,
              eval_steps=1)
    pre = torch.randn(TOY["synth_nodes"], 5,
                      generator=torch.Generator().manual_seed(3))
    torch.save(pre, tmp_path / "pretrain_embedding.pt")

    seen = {}
    real = cli.trainer_from_keys

    def spy(model, keys, config, feature=None, **k):
        seen.setdefault("port", feature)
        return real(model, keys, config, feature=feature, **k)

    def jspy(model, keys, config, feature=None, **k):
        seen["jax"] = np.asarray(feature)
        raise _Captured

    monkeypatch.setattr(cli, "trainer_from_keys", spy)
    monkeypatch.setattr(jdevice, "trainer_from_keys", jspy)
    out = cli.run_experiment(_cfg(tconfig, tmp_path / "t", **kw),
                             device="cpu")
    assert all(math.isfinite(x) for x in out["best"][0])
    with pytest.raises(_Captured):
        jcli.run_experiment(_cfg(jconfig, tmp_path / "j", **kw))
    got = seen["port"].numpy()
    assert got.shape == (TOY["synth_nodes"], 16 + 5)
    np.testing.assert_array_equal(got, seen["jax"])
    np.testing.assert_array_equal(got[:, 16:], pre.numpy())
    assert os.path.exists(tmp_path / "pretrain_embedding.pt")
