"""ZeRO-style sharding on ``torch.distributed`` ranks (``repro_torch.models.
fsdp``, the sharded ``make_train_step``, elastic checkpoints) against the
JAX reference's unsharded step, on the CPU.

Gloo ranks are spawned once a world size (``run_ranks``, a module fixture
that runs every case and returns numpy): 4 ranks on a (pod, data, model) =
(2, 2, 1) mesh and, beside them, 2 ranks on a (data, model) = (2, 1) mesh.
Meanwhile the reference's jitted steps run in a pool of processes (JAX in
the parent and its pool only; the ranks import the port, and compute the
port's unsharded gradients besides).  Both sides start from the
same parameters (the port's seeded init, carried to JAX as numpy) and the
same global batch.

* 2 ranks, fsdp: llama3.2-3b, gemma3-12b at depth 2 (window 8 < S),
  deepseek-v2 (MLA, ``moe_dispatch="ws"`` on the plain walks, B 4 x S 512:
  one routing group of 1024 tokens a rank), minicpm-2b's tied embedding
  (gathered once, its two uses' gradients summed before one
  reduce-scatter; gemma3-12b's embedding is untied in these configs),
  zamba2-2.7b's shared attention blocks (``fsdp.share`` / ``fetch``) and
  whisper-base's encoder stack (leaves the rules split along their leading
  layer dim: gathered whole, then indexed); llama with ``fsdp=False`` (data
  parallel) and with ``ws_mode="ws-wmult"``.
* 4 ranks: kimi-k2 with ``fsdp="pods"``, ``moe_dispatch="ws"`` and the
  factored optimizer (B 8 x S 512: one group a rank).
* Every rank's reassembled tree is the same bits.  Against the
  reference's step on the same inputs, within ``rtol=1e-5, atol=1e-6``
  (the optimizer test's tolerances; XLA and torch sum the same fp32
  products in other orders): the loss and the parameters after the
  update; the gradients the step hands its optimizer (reassembled from
  the shards) and the global norm the sharded optimizer clips by (summed
  over the ranks; AdamW's and the factored update's first step do not
  depend on the clip scale, so it is held on its own) against the port's
  unsharded ones.  Where the clipped gradient is not 0 but under ``G_MIN``
  (100 x AdamW's eps) the update ``g / (|g| + eps)`` turns the gradient's
  last-bit rounding into any change of ``u`` in [-1, 1] (the unsharded
  port's step shows it against the reference too: 1 such element at
  llama, 4 at deepseek), so those parameters are held to ``2 lr + 1e-6``;
  such waived elements are counted and must stay under ``WAIVED_SHARE`` of
  the tree's.
* The delicate leaves of minicpm-2b, zamba2-2.7b and whisper-base
  (``SPLIT2``) are split over the ranks in the step, and its gradients,
  reassembled, are within ``RTOL`` of each leaf's max |g| of the port's
  unsharded ``loss_and_grads``.
* Elastic checkpoints: the 4-rank state saved, restored at 2 ranks (with
  ``shardings``) and at 1 without a process group, bit-equal; a 2-rank
  run resumed from its checkpoint continues bit-equal to the uninterrupted
  one; the reference's ``restore`` reads the 4-rank file.
"""

import concurrent.futures as cf
import importlib.util
import multiprocessing
import time

import numpy as np
import pytest

RTOL, ATOL = 1e-5, 1e-6
G_MIN = 1e-6            # 100 x AdamW's eps
WAIVED_SHARE = 1e-2     # of the tree's elements: a widening waiver fails
PEAK_LR = 3e-4          # make_optimizer's (and the factored optimizer's) peak
MODS = {"llama3.2-3b": "llama3_2_3b", "gemma3-12b": "gemma3_12b", "minicpm-2b": "minicpm_2b",
        "zamba2-2.7b": "zamba2_2_7b", "whisper-base": "whisper_base",
        "deepseek-v2-236b": "deepseek_v2_236b", "kimi-k2-1t-a32b": "kimi_k2_1t_a32b"}
WS = dict(moe_dispatch="ws", moe_grad_dispatch="ws")
# name: arch, config overrides, fsdp, B, S, ws_mode
CASES2 = {
    "llama-fsdp": ("llama3.2-3b", {}, True, 4, 16, None),
    "llama-dp": ("llama3.2-3b", {}, False, 4, 16, None),
    "llama-ws-wmult": ("llama3.2-3b", {}, True, 4, 16, "ws-wmult"),
    "gemma3-fsdp": ("gemma3-12b", {"n_layers": 2}, True, 2, 24, None),
    "deepseek-fsdp": ("deepseek-v2-236b", WS, True, 4, 512, None),
    "minicpm-fsdp": ("minicpm-2b", {"n_layers": 2}, True, 2, 16, None),
    "zamba2-fsdp": ("zamba2-2.7b", {"n_layers": 4}, True, 2, 16, None),
    "whisper-fsdp": ("whisper-base", {}, True, 2, 16, None),
}
CASES4 = {"kimi-pods": ("kimi-k2-1t-a32b", WS, "pods", 8, 512, None)}
# leaves each of these cases must split over the 2 ranks, with the dim:
# minicpm-2b's tied embedding along d (gathered once for both uses, one
# reduce-scatter of the summed gradient), zamba2's shared attention blocks
# along their set dim (fsdp.share / fetch) and whisper's encoder stack along
# its layer dim, which the reference's rules split (gathered whole, then
# indexed)
SPLIT2 = {"minicpm-fsdp": {"embed": 1},
          "zamba2-fsdp": {"shared_attn/attn/wq": 0, "shared_attn/mlp/wg": 0},
          "whisper-fsdp": {"enc_layers/attn/wq": 0, "enc_layers/mlp/wg": 0}}
WS_WORKERS, WS_TAILS = 2, (3, 1)   # 4 tasks of 1 row; a round's 2 rows: 1 a rank


def _port_cfg(arch, over):
    import importlib

    cfg = importlib.import_module(f"repro_torch.configs.{MODS[arch]}").SMOKE
    return cfg.replace(**over) if over else cfg


def _flat(tree, prefix=""):
    """{path: numpy} of a nested dict of arrays or tensors."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (v.detach().float().numpy() if hasattr(v, "detach")
                               else np.asarray(v, dtype=np.float32))
    return out


def _init(arch, over):
    from repro_torch.models import init_params

    return init_params(_port_cfg(arch, over), seed=0, device="cpu")


def _batch(cfg, B, S, ws_mode):
    """A case's global batch as numpy (``cfg``: the port's config or the
    reference's, which agree)."""
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64)
    if ws_mode:
        return {"tokens": tokens.reshape(B, 1, S), "tails": np.array(WS_TAILS, np.int64)}
    if cfg.family == "encdec":
        return {"tokens": tokens, "frames": rng.standard_normal(
            (B, cfg.enc_seq_len, cfg.d_model)).astype(np.float32)}
    return {"tokens": tokens}


def _port_opt(cfg, arch):
    from repro_torch.launch.steps import make_optimizer
    from repro_torch.optim import cosine_schedule, make_adafactor_momentum

    if arch.startswith("kimi"):
        return make_adafactor_momentum(cosine_schedule(3e-4, warmup=1, total=10))
    return make_optimizer(cfg, total_steps=10)


def _mesh(shape):
    from repro_torch.launch.mesh import make_host_mesh

    return make_host_mesh(shape, ("data", "model") if len(shape) == 2 else
                          ("pod", "data", "model"))


def _sharded_state(cfg, arch, params, mesh, zero):
    from repro_torch.models import fsdp
    from repro_torch.models.sharding import use_mesh

    opt = _port_opt(cfg, arch)
    with use_mesh(mesh, zero):
        shards = fsdp.shard_params(params, mesh, zero)
        return opt, {"params": shards, "opt": opt.init(shards)}


def _step(cfg, opt, mesh, zero, ws_mode):
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.sharding import use_mesh

    with use_mesh(mesh, zero):
        if ws_mode:
            return make_train_step(cfg, opt, ws_mode=ws_mode, n_workers=WS_WORKERS)
        return make_train_step(cfg, opt)


def _whole_state(state, mesh, zero):
    """The state gathered whole: (params, every optimizer leaf) as numpy."""
    import torch

    from repro_torch.checkpoint.checkpoint import _flatten
    from repro_torch.models import fsdp
    from repro_torch.models.sharding import use_mesh

    with use_mesh(mesh, zero):
        return {p: (fsdp.unshard(t).detach().float().numpy().copy() if isinstance(t, torch.Tensor)
                    else t) for p, t in _flatten(state)}


def _capturing(opt, seen):
    """``opt`` with an ``apply`` that first records the gradients the step
    hands it, reassembled whole, and their global norm over the shards."""
    from repro_torch.models import fsdp
    from repro_torch.optim import Optimizer
    from repro_torch.optim.optimizer import global_norm

    def apply(params, grads, state):
        seen["norm"] = float(global_norm(grads, params))
        seen["grads"] = _flat(fsdp.unshard_params(fsdp.with_layouts(grads, params)))
        return opt.apply(params, grads, state)

    return Optimizer(opt.init, apply)


def _run_case(name, case, mesh):
    import torch

    from repro_torch.models import fsdp
    from repro_torch.optim import tree_leaves

    arch, over, zero, B, S, ws_mode = case
    cfg = _port_cfg(arch, over)
    opt, state = _sharded_state(cfg, arch, _init(arch, over), mesh, zero)
    resident = sum(t.numel() * t.element_size() for t in tree_leaves(state["params"]))
    n_sharded = sum(fsdp.layout_of(t) is not None for t in tree_leaves(state["params"]))
    split = {p: fsdp.layout_of(t).dim for p, t in _paths(state["params"])
             if fsdp.layout_of(t) is not None}
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, B, S, ws_mode).items()}
    seen = {}
    state, metrics = _step(cfg, _capturing(opt, seen), mesh, zero, ws_mode)(state, batch)
    return dict(state=_whole_state(state, mesh, zero), loss=metrics["loss"], resident=resident,
                n_sharded=n_sharded, split=split, **seen)


def _paths(tree, prefix=""):
    """(path, leaf) of a nested dict, paths as ``_flat`` spells them."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _paths(tree[k], f"{prefix}{k}/")
        else:
            yield prefix + k, tree[k]


def _rank4(rank, ckpt_dir):
    import torch

    from repro_torch.checkpoint import save
    from repro_torch.models.sharding import use_mesh

    mesh = _mesh((2, 2, 1))
    out = {}
    for name, case in CASES4.items():
        arch, over, zero, B, S, _ = case
        cfg = _port_cfg(arch, over)
        opt, state = _sharded_state(cfg, arch, _init(arch, over), mesh, zero)
        batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, B, S, None).items()}
        seen = {}
        state, metrics = _step(cfg, _capturing(opt, seen), mesh, zero, None)(state, batch)
        with use_mesh(mesh, zero):
            save(ckpt_dir, 1, state)
        out[name] = dict(state=_whole_state(state, mesh, zero), loss=metrics["loss"], **seen)
    out["unsharded"] = {name: _unsharded(case) for name, case in CASES4.items()} if rank == 0 \
        else {}
    return out


def _full_like(arch, over):
    cfg = _port_cfg(arch, over)
    params = _init(arch, over)
    return {"params": params, "opt": _port_opt(cfg, arch).init(params)}


def _shardings(like, mesh, zero):
    from repro_torch.launch.specs import opt_state_shardings
    from repro_torch.models.sharding import param_shardings

    p_sh = param_shardings(like["params"], mesh, fsdp=zero)
    return {"params": p_sh, "opt": opt_state_shardings(like["opt"], p_sh, mesh)}


def _rank2(rank, kimi_dir, resume_dir):
    import torch

    from repro_torch.checkpoint import latest_step, restore, save
    from repro_torch.models.sharding import use_mesh

    mesh = _mesh((2, 1))
    out = {name: _run_case(name, case, mesh) for name, case in CASES2.items()}
    out["unsharded"] = {name: _unsharded(case) for i, (name, case) in enumerate(CASES2.items())
                        if i % 2 == rank}

    # the 4-rank kimi state, restored onto 2 ranks (once the 4 ranks,
    # spawned beside these, have published it)
    deadline = time.monotonic() + 240
    while latest_step(kimi_dir) is None:
        if time.monotonic() > deadline:
            raise TimeoutError(f"no 4-rank checkpoint under {kimi_dir}")
        time.sleep(0.2)
    arch, over, zero = CASES4["kimi-pods"][:3]
    like = _full_like(arch, over)
    with use_mesh(mesh, zero):
        got, step = restore(kimi_dir, like, device="cpu",
                            shardings=_shardings(like, mesh, zero))
    out["kimi-restored"] = dict(state=_whole_state(got, mesh, zero), step=step)

    # a resumed run against the uninterrupted one from the same state
    arch, over, zero, B, S, _ = CASES2["llama-fsdp"]
    cfg = _port_cfg(arch, over)
    opt, state = _sharded_state(cfg, arch, _init(arch, over), mesh, zero)
    step_fn = _step(cfg, opt, mesh, zero, None)
    batches = [{"tokens": torch.from_numpy(np.random.default_rng(10 + i).integers(
        0, cfg.vocab_size, (B, S)))} for i in range(2)]
    state, _ = step_fn(state, batches[0])
    with use_mesh(mesh, zero):
        save(resume_dir, 1, state)
    state, _ = step_fn(state, batches[1])
    like = _full_like(arch, over)
    with use_mesh(mesh, zero):
        back, _ = restore(resume_dir, like, device="cpu",
                          shardings=_shardings(like, mesh, zero))
    back, _ = step_fn(back, batches[1])
    out["resume"] = dict(uninterrupted=_whole_state(state, mesh, zero),
                         resumed=_whole_state(back, mesh, zero))
    return out


def _expected(case):
    """A pool process's task: the reference's step of one case from the
    port's initial parameters."""
    import torch

    arch, over, zero, B, S, ws_mode = case
    torch.set_num_threads(1)
    return _reference(arch, over, B, S, ws_mode, _nested_numpy(_init(arch, over)))


def _reference(arch, over, B, S, ws_mode, params_np):
    """The reference's jitted unsharded step from ``params_np``: (params
    after it as {path: numpy}, loss)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.launch.steps import make_optimizer, make_train_step
    from repro.optim import cosine_schedule, make_adafactor_momentum

    cfg = get_config(arch, smoke=True)
    cfg = cfg.replace(**over) if over else cfg
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    opt = (make_adafactor_momentum(cosine_schedule(3e-4, warmup=1, total=10))
           if arch.startswith("kimi") else make_optimizer(cfg, total_steps=10))
    state = {"params": params, "opt": opt.init(params)}
    batch = {k: jnp.asarray(v, dtype=jnp.int32 if v.dtype.kind == "i" else v.dtype) for k, v in
             _batch(cfg, B, S, ws_mode).items()}
    kw = dict(ws_mode=ws_mode, n_workers=WS_WORKERS) if ws_mode else {}
    state, metrics = jax.jit(make_train_step(cfg, opt, **kw))(state, batch)
    return _flat(jax.tree_util.tree_map(np.asarray, state["params"])), float(metrics["loss"])


def _unsharded(case):
    """The port's gradients and their global norm on one process, no mesh
    (the port's unsharded ``loss_fn`` gradients are held to ``jax.grad`` of
    the reference's in ``tests/test_torch_train.py`` and its siblings).
    The ranks compute them, each a share of the cases, outside any mesh."""
    import torch

    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import loss_fn
    from repro_torch.optim.optimizer import global_norm
    from repro_torch.sched import ws_accumulate_grads

    arch, over, zero, B, S, ws_mode = case
    cfg = _port_cfg(arch, over)
    params = _init(arch, over)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, B, S, ws_mode).items()}
    if ws_mode:
        micro = {k: v for k, v in batch.items() if k != "tails"}
        _, grads, _ = ws_accumulate_grads(
            lambda p, fl, w: loss_fn(p, cfg, fl, row_weights=w)[0], params, micro,
            batch["tails"], n_workers=WS_WORKERS, mode=ws_mode, flat_loss=True)
    else:
        _, _, grads = loss_and_grads(params, cfg, batch)
    return _flat(grads), float(global_norm(grads))


def _nested_numpy(tree):
    return {k: _nested_numpy(v) if isinstance(v, dict) else v.detach().numpy()
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case: the reference's steps in a process pool, the 4-rank and
    the 2-rank runs at once (the 2 ranks wait for the 4 ranks' checkpoint
    before restoring it; meanwhile they compute the port's unsharded
    gradients)."""
    if importlib.util.find_spec("jax") is None:   # found, not imported: the pool imports it
        pytest.skip("jax is not installed")
    root = tmp_path_factory.mktemp("zero")
    kimi_dir, resume_dir = str(root / "kimi"), str(root / "resume")
    refs = {}
    all_cases = {**CASES4, **CASES2}   # the longest reference steps first
    keys = {name: (c[0], tuple(sorted(c[1].items())), *c[3:]) for name, c in all_cases.items()}
    with cf.ProcessPoolExecutor(max_workers=len(set(keys.values())),
                                mp_context=multiprocessing.get_context("spawn")) as pool, \
            cf.ThreadPoolExecutor(2) as spawner:
        for name, case in all_cases.items():
            if keys[name] not in refs:   # llama-dp steps the same as llama-fsdp
                refs[keys[name]] = pool.submit(_expected, case)
        from repro_torch.launch.mesh import run_ranks

        four = spawner.submit(run_ranks, _rank4, 4, kimi_dir, device="cpu", timeout=300)
        two = spawner.submit(run_ranks, _rank2, 2, kimi_dir, resume_dir, device="cpu",
                             timeout=300)
        four, two = four.result(), two.result()
        unsharded = {name: u for r in (*four, *two) for name, u in r.pop("unsharded").items()}
        want = {name: (*refs[keys[name]].result(), *unsharded[name]) for name in all_cases}
        return dict(four=four, two=two, want=want, kimi_dir=kimi_dir)


def _params_of(state):
    return {p[len("['params']"):]: v for p, v in state.items() if p.startswith("['params']")}


def _held(run, want, tag):
    """One rank's loss and updated parameters against the reference's step,
    its gradients and global norm against the port's unsharded ones (see
    the module docstring for ``G_MIN``)."""
    want_params, want_loss, want_grads, want_norm = want
    np.testing.assert_allclose(run["loss"], want_loss, rtol=RTOL, atol=ATOL, err_msg=tag)
    np.testing.assert_allclose(run["norm"], want_norm, rtol=RTOL, err_msg=tag)
    assert run["grads"].keys() == want_grads.keys(), tag
    for path, w in want_grads.items():
        np.testing.assert_allclose(run["grads"][path], w, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{tag} gradient {path}")
    got = _params_of(run["state"])
    assert len(got) == len(want_params), tag
    clip = min(1.0, 1.0 / want_norm)   # the optimizers' clip_norm 1.0
    waived = total = 0
    for path, w in want_params.items():
        key = "".join(f"[{k!r}]" for k in path.split("/"))
        g = np.abs(want_grads[path])
        flat = (g > 0) & (g * clip < G_MIN)
        np.testing.assert_allclose(got[key][~flat], w[~flat], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{tag} {path}")
        assert np.all(np.abs(got[key][flat] - w[flat]) <= 2 * PEAK_LR + ATOL), f"{tag} {path}"
        waived += int(flat.sum())
        total += w.size
    assert waived <= WAIVED_SHARE * total, f"{tag}: {waived} of {total} elements waived"


def _bit_equal(a, b, tag):
    assert a.keys() == b.keys(), tag
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{tag} {k}")
        else:
            assert a[k] == b[k], f"{tag} {k}"


@pytest.mark.parametrize("name", list(CASES2))
def test_two_ranks_match_the_unsharded_reference_step(runs, name):
    ranks = [r[name] for r in runs["two"]]
    _bit_equal(ranks[0]["state"], ranks[1]["state"], f"{name}: rank 0 vs rank 1")
    assert ranks[0]["loss"] == ranks[1]["loss"]
    _held(ranks[0], runs["want"][name], name)
    zero = CASES2[name][2]
    if zero:   # the shard is what a rank holds: well under the whole tree
        whole = sum(v.size * 4 for v in _params_of(ranks[0]["state"]).values())
        assert ranks[0]["n_sharded"] > 0 and ranks[0]["resident"] < 0.75 * whole
    else:
        assert ranks[0]["n_sharded"] == 0


@pytest.mark.parametrize("name", list(SPLIT2))
def test_two_ranks_match_the_unsharded_port(runs, name):
    """The case's delicate leaves are split, and the step's gradients on
    every rank are the port's unsharded ones within RTOL of each leaf's
    max |g| (the reference's step holds them elementwise above)."""
    want_grads = runs["want"][name][2]
    for r in runs["two"]:
        run = r[name]
        for path, dim in SPLIT2[name].items():
            assert run["split"].get(path) == dim, (name, path, run["split"])
        for path, w in want_grads.items():
            err = np.abs(run["grads"][path] - w).max() / max(np.abs(w).max(), 1e-30)
            assert err <= RTOL, (name, path, err)


def test_four_ranks_pods_factored_match_the_reference(runs):
    ranks = [r["kimi-pods"] for r in runs["four"]]
    for r in ranks[1:]:
        _bit_equal(ranks[0]["state"], r["state"], "kimi-pods: rank 0 vs another")
    _held(ranks[0], runs["want"]["kimi-pods"], "kimi-pods")
    # the factored second moment's pairs are in the state, whole
    assert any(k.endswith("[0]") for k in ranks[0]["state"] if k.startswith("['opt'].v"))


def test_elastic_restore_from_four_ranks(runs):
    saved = runs["four"][0]["kimi-pods"]["state"]
    for r in runs["two"]:
        assert r["kimi-restored"]["step"] == 1
        _bit_equal(r["kimi-restored"]["state"], saved, "restored at 2 ranks")
    from repro_torch.checkpoint import restore

    arch, over, zero = CASES4["kimi-pods"][:3]
    got, step = restore(runs["kimi_dir"], _full_like(arch, over), device="cpu")
    from repro_torch.checkpoint.checkpoint import _flatten

    one = {p: (t.float().numpy() if hasattr(t, "detach") else t) for p, t in _flatten(got)}
    assert step == 1
    _bit_equal(one, saved, "restored at 1 rank")


def test_resumed_two_rank_run_is_bit_equal(runs):
    for r in runs["two"]:
        _bit_equal(r["resume"]["resumed"], r["resume"]["uninterrupted"], "resumed vs not")


def test_reference_restore_reads_the_four_rank_file(runs):
    """The reference's ``restore`` reads the parameters of the file the 4
    ranks wrote (its ``astype`` has no cast from the ``|V2`` payload of its
    own bf16 leaves, so the bf16 momentum is left out of ``like``)."""
    import jax

    from repro.checkpoint import restore as j_restore

    saved = runs["four"][0]["kimi-pods"]["state"]
    arch, over, _ = CASES4["kimi-pods"][:3]
    params = _init(arch, over)
    jlike = {"params": jax.tree_util.tree_map(
        lambda t: jax.ShapeDtypeStruct(tuple(t.shape), np.float32), _nested_numpy(params))}
    got, step = j_restore(runs["kimi_dir"], jlike)
    assert step == 1
    want = _params_of(saved)
    gflat = _flat(jax.tree_util.tree_map(np.asarray, got["params"]))
    assert len(gflat) == len(want)
    for path, v in gflat.items():
        key = "".join(f"[{k!r}]" for k in path.split("/"))
        np.testing.assert_array_equal(v, want[key], err_msg=path)
