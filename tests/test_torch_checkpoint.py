"""The port's checkpoints (``repro_torch.checkpoint``) and the trainer's
resume against the JAX package's, on the CPU at smoke size.

* the round trip: every leaf of a train state (params, AdamW's m and v, the
  step) back bit for bit, fp32 and bf16 leaves alike (a bf16 leaf is its
  16-bit payload on disk, ``|V2`` as the reference writes it);
* a bf16 tree saved by both packages: the same npz dtype and bytes, and
  the port restores the reference's file, its own and an ``int16``-payload
  file (the port's earlier format) to equal tensors;
* ``latest_step`` ignoring ``.tmp-`` directories, the tear drill and the
  background writer's error (the cases of tests/test_chaos.py), the
  snapshot taken before ``AsyncCheckpointer.save`` returns, ``keep=3``;
* the on-disk layout shared with the reference: a reference-written fp32
  train state restores in the port and a port-written one in the
  reference, leaf for leaf (keys in ``jax.tree_util.keystr`` form);
* ``train()``: the reference's resume case (11 steps, then a resume to 16)
  from the reference's initial weights, its losses within 1e-5 of the
  reference's own run of that case (fp32, the same sums in another order),
  and the preemption drill in a subprocess (exit 17, then ``resume``), its
  losses bit-equal to an uninterrupted run's.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore, save
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.optim.optimizer import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))


def _state(dtype, seed=0):
    """A llama smoke train state after one AdamW step, params in ``dtype``."""
    from repro_torch.configs.llama3_2_3b import SMOKE
    from repro_torch.launch.steps import make_optimizer, make_train_step
    from repro_torch.models import init_params

    cfg = SMOKE.replace(dtype=dtype)
    opt = make_optimizer(cfg, total_steps=4)
    params = init_params(cfg, seed=seed, device="cpu")
    state = {"params": params, "opt": opt.init(params)}
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 16)))
    state, _ = make_train_step(cfg, opt)(state, {"tokens": tokens})
    return state


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _assert_bit_equal(got, want):
    assert type(got) is type(want)
    if isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(_bits(got), _bits(want))
    else:
        assert got == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_round_trip_is_bit_equal(tmp_path, dtype):
    state = _state(dtype)
    save(str(tmp_path), 7, state, metadata={"arch": "llama3.2-3b"})
    like = _state(dtype, seed=1)
    got, step = restore(str(tmp_path), like, device="cpu")
    assert step == 7 and got["opt"].step == state["opt"].step == 1
    assert type(got["opt"]) is type(state["opt"])
    flat_got, flat_want = ckpt._flatten(got), ckpt._flatten(state)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (_, g), (_, w) in zip(flat_got, flat_want):
        _assert_bit_equal(g, w)
    with open(tmp_path / "step_00000007" / "manifest.json") as f:
        manifest = json.load(f)
    dtypes = {leaf["path"]: leaf["dtype"] for leaf in manifest["leaves"]}
    assert dtypes["['params']['embed']"] == dtype
    assert dtypes["['opt'].m['embed']"] == "float32"
    assert manifest["metadata"] == {"arch": "llama3.2-3b"}
    with np.load(tmp_path / "step_00000007" / "arrays-0.npz") as z:
        want = np.dtype("V2") if dtype == "bfloat16" else np.float32
        assert z["['params']['embed']"].dtype == want


def test_restore_refuses_a_missing_leaf_and_a_wrong_shape(tmp_path):
    save(str(tmp_path), 1, {"w": torch.zeros(3)})
    with pytest.raises(KeyError):
        restore(str(tmp_path), {"b": torch.zeros(3)}, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        restore(str(tmp_path), {"w": torch.zeros(4)}, device="cpu")
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path / "none"), {"w": torch.zeros(3)}, device="cpu")


def test_latest_step_ignores_tmp_directories(tmp_path):
    assert latest_step(str(tmp_path / "absent")) is None
    save(str(tmp_path), 3, {"w": torch.arange(4.0)})
    stale = tmp_path / "step_00000009.tmp-dead"
    stale.mkdir()
    (stale / "manifest.json").write_text("{}")
    (tmp_path / "step_00000011").mkdir()  # no manifest: not published
    assert latest_step(str(tmp_path)) == 3


def test_checkpoint_crash_mid_publish_never_tears(tmp_path, monkeypatch):
    d = str(tmp_path)
    tree = {"w": np.arange(4.0), "b": np.zeros(2)}
    save(d, 1, tree)
    assert latest_step(d) == 1

    def crash(src, dst):
        raise OSError("simulated crash mid-publish")

    monkeypatch.setattr(ckpt.os, "rename", crash)
    with pytest.raises(OSError):
        save(d, 2, {"w": np.arange(4.0) + 1, "b": np.ones(2)})
    assert latest_step(d) == 1, "latest_step torn by a failed publish"
    assert not [n for n in os.listdir(d) if ".tmp-" in n], "the failed save left its tmp dir"
    stale = tmp_path / "step_00000009.tmp-dead"
    stale.mkdir()
    (stale / "manifest.json").write_text("{}")
    assert latest_step(d) == 1
    monkeypatch.undo()
    restored, step = restore(d, tree, device="cpu")
    assert step == 1
    np.testing.assert_array_equal(restored["w"].numpy(), tree["w"])


def test_async_checkpointer_surfaces_crash(tmp_path, monkeypatch):
    d = str(tmp_path)
    save(d, 1, {"w": np.zeros(3)})
    ac = AsyncCheckpointer(d)

    def crash(src, dst):
        raise OSError("simulated crash in the background writer")

    monkeypatch.setattr(ckpt.os, "rename", crash)
    ac.save(2, {"w": np.ones(3)})
    with pytest.raises(OSError):
        ac.wait()  # the error is surfaced, not swallowed
    assert latest_step(d) == 1
    ac.wait()  # raised once


def test_async_snapshot_is_taken_before_save_returns(tmp_path):
    w = torch.ones(1000)
    ac = AsyncCheckpointer(str(tmp_path))
    ac.save(1, {"w": w, "n": 5})
    w.add_(1.0)  # training updates the tensor in place while the writer runs
    ac.wait()
    got, _ = restore(str(tmp_path), {"w": w, "n": 0}, device="cpu")
    assert torch.equal(got["w"], torch.ones(1000)) and got["n"] == 5
    (rec,) = ac.records
    assert rec["step"] == 1 and rec["bytes"] >= 4000
    assert rec["snapshot_s"] >= 0 and rec["write_s"] > 0


def test_async_checkpointer_keeps_three(tmp_path):
    ac = AsyncCheckpointer(str(tmp_path))
    for step in range(1, 6):
        ac.save(step, {"w": torch.full((2,), float(step))})
    ac.wait()
    assert sorted(os.listdir(tmp_path)) == [f"step_{s:08d}" for s in (3, 4, 5)]
    got, step = restore(str(tmp_path), {"w": torch.zeros(2)}, device="cpu")
    assert step == 5 and torch.equal(got["w"], torch.full((2,), 5.0))


# ---------------------------------------------------------------------------
# the layout shared with the reference

jax = pytest.importorskip("jax")


def _reference_state():
    """The reference's llama smoke train state after one jitted step (fp32)."""
    import jax.numpy as jnp

    from repro.configs import get_config as j_get_config
    from repro.launch.steps import make_optimizer as j_make_optimizer
    from repro.launch.steps import make_train_step as j_make_train_step
    from repro.models import init_params as j_init

    cfg = j_get_config("llama3.2-3b", smoke=True)
    opt = j_make_optimizer(cfg, total_steps=4)
    params = j_init(jax.random.PRNGKey(0), cfg)
    state = {"params": params, "opt": opt.init(params)}
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    state, _ = jax.jit(j_make_train_step(cfg, opt))(state, {"tokens": jnp.asarray(tokens)})
    return state


def test_reference_written_state_restores_in_the_port(tmp_path):
    from repro.checkpoint import save as j_save

    jstate = _reference_state()
    j_save(str(tmp_path), 4, jstate)
    like = _state("float32", seed=1)
    got, step = restore(str(tmp_path), like, device="cpu")
    assert step == 4 and got["opt"].step == int(jstate["opt"].step) == 1
    want = dict(ckpt._flatten(jax.tree_util.tree_map(np.asarray, jstate)))
    flat = ckpt._flatten(got)
    assert len(flat) == len(want)
    for path, g in flat:
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_array_equal(g, want[path], err_msg=path)


def test_port_written_state_restores_in_the_reference(tmp_path):
    from repro.checkpoint import latest_step as j_latest_step
    from repro.checkpoint import restore as j_restore

    state = _state("float32")
    save(str(tmp_path), 6, state)
    assert j_latest_step(str(tmp_path)) == 6
    like = jax.tree_util.tree_map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                                  _reference_state())
    got, step = j_restore(str(tmp_path), like)
    assert step == 6 and int(got["opt"].step) == 1
    want = dict(ckpt._flatten(state))
    flat = ckpt._flatten(jax.tree_util.tree_map(np.asarray, got))
    assert [p for p, _ in flat] == list(want)
    for path, g in flat:
        w = want[path]
        w = w.detach().numpy() if isinstance(w, torch.Tensor) else w
        np.testing.assert_array_equal(g, w, err_msg=path)


def test_bf16_files_match_the_reference_on_disk(tmp_path):
    """The same bf16 tree saved by both packages carries one npz dtype
    (``|V2``) and one payload; the port restores either file, and a file
    whose payload is ``int16``, to the tensors saved."""
    import jax.numpy as jnp

    from repro.checkpoint import save as j_save

    vals = np.random.default_rng(3).normal(size=(5, 7)).astype(np.float32)
    vals[0, :4] = [1.5, -2.25, 3.0, 0.1]
    tree = {"b": torch.from_numpy(vals[1]).to(torch.bfloat16),
            "w": torch.from_numpy(vals).to(torch.bfloat16)}
    jtree = {k: jnp.asarray(vals[1] if k == "b" else vals, dtype=jnp.bfloat16) for k in tree}
    assert all(np.array_equal(np.asarray(jtree[k]).view(np.int16), tree[k].view(torch.int16)
                              .numpy()) for k in tree)
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    save(port, 1, tree)
    j_save(ref, 1, jtree)
    payload = {}
    for d in (port, ref):
        with np.load(os.path.join(d, "step_00000001", "arrays-0.npz")) as z:
            payload[d] = {k: z[k] for k in z.files}
        with open(os.path.join(d, "step_00000001", "manifest.json")) as f:
            assert {leaf["dtype"] for leaf in json.load(f)["leaves"]} == {"bfloat16"}
    assert sorted(payload[port]) == sorted(payload[ref]) == ["['b']", "['w']"]
    for k in payload[port]:
        a, b = payload[port][k], payload[ref][k]
        assert a.dtype == b.dtype == np.dtype("V2"), (k, a.dtype, b.dtype)
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), k
    # the port's earlier format: the same payload stored as int16
    old = str(tmp_path / "old")
    save(old, 1, tree)
    npz = os.path.join(old, "step_00000001", "arrays-0.npz")
    np.savez(npz, **{k: v.view(np.int16) for k, v in payload[port].items()})
    with np.load(npz) as z:
        assert all(z[k].dtype == np.int16 for k in z.files)
    like = {k: torch.zeros_like(v) for k, v in tree.items()}
    for d in (port, ref, old):
        got, step = restore(d, like, device="cpu")
        assert step == 1
        for k in tree:
            assert got[k].dtype == torch.bfloat16
            assert torch.equal(got[k].view(torch.int16), tree[k].view(torch.int16)), (d, k)


# ---------------------------------------------------------------------------
# train(): resume and preemption

def _reference_resume_losses(d):
    from repro.launch.train import train as j_train

    j_train("llama3.2-3b", smoke=True, steps=11, rows=2, seq=16, ckpt_dir=d, ckpt_every=5,
            log_every=50)
    _, losses = j_train("llama3.2-3b", smoke=True, steps=16, rows=2, seq=16, ckpt_dir=d,
                        ckpt_every=5, resume=True, log_every=50)
    return losses


def test_train_resume_continues_as_the_reference(tmp_path):
    """The reference's case (tests/test_launch.py): 11 steps with a save
    every 5 (and at the last), then ``resume`` to 16; only steps 11..15 run,
    and from the reference's initial weights their losses are the
    reference's."""
    from repro.configs import get_config as j_get_config
    from repro.models import init_params as j_init
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.train import train

    init = jax.tree_util.tree_map(
        np.asarray, j_init(jax.random.PRNGKey(0), j_get_config("llama3.2-3b", smoke=True)))
    d = str(tmp_path / "ck")
    _, first = train("llama3.2-3b", steps=11, rows=2, seq=16, ckpt_dir=d, ckpt_every=5,
                     log_every=50, device="cpu", params=params_from_jax(init, device="cpu"))
    assert latest_step(d) == 10 and len(first) == 11
    _, losses = train("llama3.2-3b", steps=16, rows=2, seq=16, ckpt_dir=d, ckpt_every=5,
                      resume=True, log_every=50, device="cpu",
                      params=params_from_jax(init, device="cpu"))
    assert latest_step(d) == 15
    assert len(losses) == 5  # only steps 11..15 ran
    want = _reference_resume_losses(str(tmp_path / "jck"))
    np.testing.assert_allclose(losses, want, rtol=0, atol=1e-5)


def test_preempted_run_resumes_bit_equal(tmp_path):
    """``preempt_at`` in a process of its own exits 17 after its step's
    save; ``resume`` then continues from the saved step, and every loss of
    the resumed steps equals the uninterrupted run's bit for bit."""
    from repro_torch.launch.train import train

    d = str(tmp_path / "ck")
    args = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "llama3.2-3b",
            "--steps", "8", "--rows", "2", "--seq", "16", "--ckpt-dir", d, "--ckpt-every",
            "2", "--preempt-at", "5", "--device", "cpu", "--log-every", "1"]
    proc = subprocess.run(args, capture_output=True, text=True, env=ENV, timeout=300)
    assert proc.returncode == 17, proc.stdout + proc.stderr
    assert "simulating preemption at step 5" in proc.stdout
    assert latest_step(d) == 4
    _, resumed = train("llama3.2-3b", steps=8, rows=2, seq=16, ckpt_dir=d, ckpt_every=2,
                       resume=True, log_every=50, device="cpu")
    _, whole = train("llama3.2-3b", steps=8, rows=2, seq=16, log_every=50, device="cpu")
    assert len(resumed) == 3 and resumed == whole[5:]
    assert latest_step(d) == 7
    assert all(np.isfinite(resumed))


def test_train_cli_takes_the_checkpoint_flags(tmp_path):
    from repro_torch.launch.train import main

    d = str(tmp_path / "ck")
    assert main(["--arch", "llama3.2-3b", "--steps", "3", "--rows", "2", "--seq", "16",
                 "--ckpt-dir", d, "--ckpt-every", "2", "--device", "cpu"]) == 0
    assert latest_step(d) == 2
    assert sorted(os.listdir(d)) == ["step_00000000", "step_00000002"]
    got, _ = restore(d, {"params": {"embed": torch.zeros(256, 64)}}, step=2, device="cpu")
    assert got["params"]["embed"].dtype == torch.float32
    assert len(list(tree_leaves(got))) == 1
