"""The port's checkpoints against the JAX package's: one on-disk layout,
readable both ways.

A reference ``save_fit_result`` restores in the port with bitwise-equal
factors (bf16 as its fp32 carrier), trace and config fields, and a port
checkpoint restores in the reference (bf16 as bf16, from the sidecar the
port writes).  Corrupted newest steps are quarantined and never boot, and
a port ``solve`` warm-started from a restored result equals the
uninterrupted run bitwise.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import tolerance as tol

from repro import api as rapi
from repro import checkpoint as rck
from repro.runtime.chaos import bitflip_checkpoint

from repro_torch import api as tapi
from repro_torch import checkpoint as tck
from repro_torch.core.schedule import OwnershipSchedule
from repro_torch.core.stepsize import PowerSchedule
from repro_torch.serve import FactorStore


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.from_numpy(rng.normal(size=(4, 4))).float(),
                   "blocks": [torch.from_numpy(
                       rng.normal(size=(2, 3))).bfloat16()]},
        "opt": {"m": rng.normal(size=(4,)).astype(np.float32),
                "step": np.asarray(7, np.int32)},
    }


def _leaves(tree):
    return [leaf for _, leaf in tck.checkpoint._leaves(tree)]


def test_roundtrip_keys_and_dtypes(tmp_path):
    t = _tree()
    tck.save_checkpoint(str(tmp_path), 5, t)
    restored, step = tck.restore_checkpoint(str(tmp_path), t)
    assert step == 5
    for a, b in zip(_leaves(t), _leaves(restored)):
        assert type(a) is type(b) and a.dtype == b.dtype
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            tol.assert_bitwise(np.atleast_1d(a), np.atleast_1d(b))
    with np.load(tmp_path / "step_00000005" / "shard_0.npz") as data:
        assert sorted(data.files) == [
            "__dtype__/params/blocks/0", "opt/m", "opt/step",
            "params/blocks/0", "params/w"]
        assert str(data["__dtype__/params/blocks/0"]) == "bfloat16"


def test_latest_step_ignores_uncommitted_and_empty_dir(tmp_path):
    t = _tree()
    tck.save_checkpoint(str(tmp_path), 1, t)
    tck.save_checkpoint(str(tmp_path), 3, t)
    os.makedirs(tmp_path / "step_00000009")
    (tmp_path / "step_00000009" / "shard_0.npz").write_bytes(b"garbage")
    assert tck.latest_step(str(tmp_path)) == 3
    assert tck.restore_checkpoint(str(tmp_path), t)[1] == 3
    assert tck.restore_checkpoint(str(tmp_path / "nope"), t) == (None, None)
    assert tck.restore_fit_result(str(tmp_path / "nope")) == (None, None)


def test_async_checkpointer_and_gc(tmp_path):
    ck = tck.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (10, 20, 30, 40):
        ck.save(s, _tree(s))
    ck.wait()
    assert tck.committed_steps(str(tmp_path)) == [30, 40]
    restored, step = tck.restore_checkpoint(str(tmp_path), _tree())
    assert step == 40
    assert torch.equal(restored["params"]["w"], _tree(40)["params"]["w"])


def test_gc_spares_latest_committed_despite_torn_newer(tmp_path):
    for s in (1, 2, 3):
        tck.save_checkpoint(str(tmp_path), s, _tree(s))
    os.makedirs(tmp_path / "step_00000004.tmp")
    os.makedirs(tmp_path / "step_00000000.tmp")
    tck.gc_checkpoints(str(tmp_path), keep=1)
    assert sorted(os.listdir(tmp_path)) == ["step_00000003",
                                            "step_00000004.tmp"]
    with pytest.raises(ValueError, match="keep"):
        tck.gc_checkpoints(str(tmp_path), keep=0)


def _problems(d):
    return (tapi.MCProblem.from_coo(*d["train"], d["m"], d["n"],
                                    test=d["test"]),
            rapi.MCProblem.from_coo(*d["train"], d["m"], d["n"],
                                    test=d["test"]))


def _warm(api, d, k):
    rng = np.random.default_rng(0)
    return api.FitResult(
        W=rng.uniform(0, 1 / np.sqrt(k), (d["m"], k)).astype(np.float32),
        H=rng.uniform(0, 1 / np.sqrt(k), (d["n"], k)).astype(np.float32),
        trace_epochs=np.zeros(0), trace_rmse=np.zeros(0), epochs_done=0)


def _cfg_kw(policy):
    return dict(k=4, p=3, lam=0.05, epochs=2, kernel="wave_pallas",
                dtype_policy=policy, stepsize=None, schedule="balanced",
                fuse_epochs=1, record_every=1)


def _same_config(t, r):
    for f in dataclasses.fields(r):
        a, b = getattr(t, f.name), getattr(r, f.name)
        if f.name == "kernel":
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        elif f.name == "stepsize":
            assert (a is None) == (b is None)
            if a is not None:
                assert (a.alpha, a.beta) == (b.alpha, b.beta)
        elif f.name == "schedule" and not isinstance(a, str):
            assert (a.p, a.name) == (b.p, b.name)
            np.testing.assert_array_equal(np.asarray(a.table), b.table)
            np.testing.assert_array_equal(np.asarray(a.active), b.active)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_reference_checkpoint_restores_in_port(tmp_path, tiny_mc_problem,
                                               policy):
    d = tiny_mc_problem
    _, rp = _problems(d)
    cfg = rapi.NomadConfig(**{**_cfg_kw(policy),
                              "stepsize": rapi.PowerSchedule(0.05, 0.05)})
    res = rapi.solve(rp, cfg, warm_start=_warm(rapi, d, 4))
    rck.save_fit_result(str(tmp_path), 2, res)
    got, step = tck.restore_fit_result(str(tmp_path))
    assert step == 2
    for x in ("W", "H"):
        want = np.asarray(getattr(res, x)).astype(np.float32)
        tol.assert_bitwise(getattr(got, x), want, x)
    tol.assert_bitwise(got.trace_epochs, np.asarray(res.trace_epochs))
    tol.assert_bitwise(got.trace_rmse, np.asarray(res.trace_rmse))
    assert got.epochs_done == res.epochs_done and got.solver == "nomad"
    assert isinstance(got.config, tapi.NomadConfig)
    _same_config(got.config, cfg)
    # the port's server boots from it, in the run's storage dtype
    view = FactorStore.from_checkpoint(str(tmp_path), device="cpu").view()
    assert view.W.dtype == (torch.bfloat16 if policy == "bf16"
                            else torch.float32)
    tol.assert_bitwise(view.W.float().numpy(),
                       np.asarray(res.W).astype(np.float32), "served W")


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_port_checkpoint_restores_in_reference(tmp_path, tiny_mc_problem,
                                               policy):
    d = tiny_mc_problem
    tp, _ = _problems(d)
    sched = OwnershipSchedule.random(3, seed=4)
    cfg = tapi.NomadConfig(**{**_cfg_kw(policy), "schedule": sched,
                              "stepsize": PowerSchedule(0.05, 0.05)})
    res = tapi.solve(tp, cfg, warm_start=_warm(tapi, d, 4), device="cpu")
    tck.save_fit_result(str(tmp_path), 2, res)
    got, step = rck.restore_fit_result(str(tmp_path))
    assert step == 2
    want_dtype = "bfloat16" if policy == "bf16" else "float32"
    for x in ("W", "H"):
        assert np.asarray(getattr(got, x)).dtype.name == want_dtype
        tol.assert_bitwise(np.asarray(getattr(got, x)).astype(np.float32),
                           getattr(res, x), x)
    tol.assert_bitwise(np.asarray(got.trace_rmse), res.trace_rmse)
    assert got.epochs_done == 2 and isinstance(got.config, rapi.NomadConfig)
    _same_config(cfg, got.config)
    # and back: the port reads its own checkpoint bitwise
    back, _ = tck.restore_fit_result(str(tmp_path))
    tol.assert_bitwise(back.W, res.W, "port W")
    assert back.config.schedule.name == sched.name
    with open(tmp_path / "step_00000002" / "manifest.json") as f:
        keys = sorted(json.load(f)["arrays"])
    want = ["H", "W", "trace_epochs", "trace_rmse"]
    if policy == "bf16":
        want = ["H", "W", "__dtype__/H", "__dtype__/W", "trace_epochs",
                "trace_rmse"]
    assert keys == sorted(want)


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_warm_start_from_restored_equals_uninterrupted(tmp_path,
                                                       tiny_mc_problem,
                                                       policy):
    d = tiny_mc_problem
    tp, _ = _problems(d)
    kw = {**_cfg_kw(policy), "stepsize": PowerSchedule(0.05, 0.05)}
    whole = tapi.solve(tp, tapi.NomadConfig(**{**kw, "epochs": 3}),
                       warm_start=_warm(tapi, d, 4), device="cpu")
    first = tapi.solve(tp, tapi.NomadConfig(**{**kw, "epochs": 1}),
                       warm_start=_warm(tapi, d, 4), device="cpu")
    tck.save_fit_result(str(tmp_path), 1, first)
    restored, _ = tck.restore_fit_result(str(tmp_path))
    rest = tapi.solve(tp, dataclasses.replace(restored.config, epochs=2),
                      warm_start=restored, device="cpu")
    tol.assert_bitwise(rest.W, whole.W, "W")
    tol.assert_bitwise(rest.H, whole.H, "H")
    np.testing.assert_array_equal(
        np.concatenate([first.trace_rmse, rest.trace_rmse]),
        whole.trace_rmse)


def test_bitflipped_newest_step_is_quarantined_and_never_boots(tmp_path):
    rng = np.random.default_rng(2)
    results = []
    for step in (1, 2):
        res = tapi.FitResult(
            W=rng.normal(size=(7, 3)).astype(np.float32),
            H=rng.normal(size=(5, 3)).astype(np.float32),
            trace_epochs=np.arange(1, step + 1),
            trace_rmse=rng.random(step), epochs_done=step,
            config=tapi.NomadConfig(k=3, p=2, epochs=step))
        tck.save_fit_result(str(tmp_path), step, res)
        results.append(res)
    assert tck.verify_checkpoint(str(tmp_path), 2)
    assert bitflip_checkpoint(str(tmp_path), seed=3) == 2
    assert not tck.verify_checkpoint(str(tmp_path), 2)
    with pytest.raises(tck.CorruptCheckpointError):
        tck.restore_fit_result(str(tmp_path), step=2)
    store = FactorStore.from_checkpoint(str(tmp_path), device="cpu")
    assert store.boot_step == 1
    tol.assert_bitwise(store.view().W.numpy(), results[0].W, "booted W")
    assert os.path.isdir(tmp_path / "step_00000002.corrupt")
    assert tck.committed_steps(str(tmp_path)) == [1]
    assert tck.latest_verified_step(str(tmp_path)) == 1
    bitflip_checkpoint(str(tmp_path), seed=0, step=1)
    assert tck.restore_fit_result(str(tmp_path)) == (None, None)
    with pytest.raises(FileNotFoundError):
        FactorStore.from_checkpoint(str(tmp_path), device="cpu")


def test_config_codecs_refuse_what_is_not_ported(tmp_path):
    # the runtime types round-trip, and decode what the reference wrote
    from repro.checkpoint import checkpoint as rck
    from repro.runtime import chaos as rchaos
    from repro.runtime.transport import TransportConfig as RTransport
    from repro_torch.runtime import chaos as tchaos
    from repro_torch.runtime.transport import TransportConfig
    enc = rck._encode_value(RTransport(max_retries=7))
    got = tck.checkpoint._decode_value(enc)
    assert isinstance(got, TransportConfig) and got.max_retries == 7
    assert tck.checkpoint._encode_value(got) == enc
    link = tchaos.DegradedLink([tchaos.LinkEvent("drop", t1=5.0)],
                               dup=0.25, delay_factor=3.0)
    enc = tck.checkpoint._encode_value(link)
    assert enc == rck._encode_value(rchaos.DegradedLink(
        [rchaos.LinkEvent("drop", t1=5.0)], dup=0.25, delay_factor=3.0))
    back = tck.checkpoint._decode_value(enc)
    assert back.rates == link.rates and back.events == link.events
    with pytest.raises(ValueError, match="unknown config"):
        tck.checkpoint._decode_config({"__config__": "SgdNoSuchConfig",
                                       "fields": {}})
    with pytest.raises(ValueError, match="unknown checkpoint value tag"):
        tck.checkpoint._decode_value({"__type__": "Nope"})
    enc = tck.checkpoint._encode_value((1, np.int64(2), np.float32(0.5)))
    assert tck.checkpoint._decode_value(enc) == (1, 2, 0.5)
