"""The port's sharding rules (``repro_torch.models.sharding``,
``repro_torch.launch.specs.opt_state_shardings``) against the reference's,
and the sharded step's refusals; no ranks.

* ``param_spec`` through ``param_shardings`` and ``spec_for`` equal the
  reference's for every leaf of all ten configs at full size (shapes from
  ``jax.eval_shape`` of the reference's init, which allocates nothing), on
  16 x 16, 2 x 16 x 16, (2, 2), (4, 1) and (1, 4) meshes with fsdp
  ``False``, ``True`` and ``"pods"``.  ``_resolve`` reads only
  ``axis_names`` and ``shape``, so a plain namespace stands in for a JAX
  mesh, and the reference's ``NamedSharding`` is replaced by one that keeps
  its spec.
* ``opt_state_shardings`` follows the reference's rule, factored pairs
  included, for each config's policy optimizer.
* ``make_train_step`` raises for gemma3-12b at full size with no mesh and
  builds under a fsdp data mesh; a ``"model"`` axis over 1 raises; a batch
  that splits a MoE routing group across data ranks raises, on both
  dispatches; rows that do not split over the ranks raise.
"""

import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro_torch.configs import ARCH_MODULES, get_config  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.launch.specs import opt_state_shardings  # noqa: E402
from repro_torch.models import param_shardings, shard, use_mesh  # noqa: E402
from repro_torch.models import fsdp  # noqa: E402
from repro_torch.models.sharding import spec_for  # noqa: E402
from repro_torch.optim import OptState  # noqa: E402

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2}, "4x1": {"data": 4, "model": 1},
          "1x4": {"data": 1, "model": 4}}
FSDP = (False, True, "pods")


def _mesh(shape):
    return types.SimpleNamespace(axis_names=tuple(shape), shape=dict(shape))


@pytest.fixture(scope="module")
def shapes():
    """Every config's parameter shapes at full size, from the reference."""
    out = {}
    for arch in ARCH_IDS:
        cfg = j_get_config(arch)
        out[arch] = jax.eval_shape(lambda cfg=cfg: j_init(jax.random.PRNGKey(0), cfg))
    return out


@pytest.fixture
def ref_specs(monkeypatch):
    """The reference's ``param_shardings`` and ``opt_state_shardings`` with a
    ``NamedSharding`` that keeps (mesh, spec) and checks nothing."""
    import repro.launch.specs as j_specs
    import repro.models.sharding as j_sharding

    keep = lambda mesh, spec: types.SimpleNamespace(mesh=mesh, spec=spec)  # noqa: E731
    monkeypatch.setattr(j_sharding, "NamedSharding", keep)
    monkeypatch.setattr(j_specs, "NamedSharding", keep)
    return j_sharding.param_shardings, j_specs.opt_state_shardings


def _stand_ins(tree):
    """A reference shape tree as the port's: nested dicts of things with
    ``.shape``."""
    if isinstance(tree, dict):
        return {k: _stand_ins(v) for k, v in tree.items()}
    return types.SimpleNamespace(shape=tuple(tree.shape))


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree) for p, v in _paths(tree[k], f"{prefix}/{k}").items()}
    return {prefix: tree}


def test_port_knows_every_reference_arch():
    assert set(ARCH_MODULES) == set(ARCH_IDS)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_specs_equal_the_reference(shapes, ref_specs, mesh_name):
    j_param_shardings, _ = ref_specs
    mesh = _mesh(MESHES[mesh_name])
    for arch, tree in shapes.items():
        for zero in FSDP:
            want = _paths(j_param_shardings(tree, mesh, fsdp=zero))
            got = _paths(param_shardings(_stand_ins(tree), mesh, fsdp=zero))
            assert got.keys() == want.keys(), arch
            for path, sh in want.items():
                assert tuple(got[path].spec) == tuple(sh.spec), (arch, zero, path)
                assert got[path].mesh is mesh


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_spec_for_equals_the_reference(mesh_name):
    from repro.models.sharding import spec_for as j_spec_for

    mesh = _mesh(MESHES[mesh_name])
    logical = ("dp", "tp", "fsdp", "fsdp+", "sp", None, "model", "pod")
    rng = np.random.default_rng(0)
    for _ in range(200):
        nd = int(rng.integers(1, 5))
        shape = tuple(int(rng.choice([1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 256, 4096]))
                      for _ in range(nd))
        axes = tuple(logical[int(rng.integers(len(logical)))] for _ in range(nd))
        assert tuple(spec_for(shape, axes, mesh)) == tuple(j_spec_for(shape, axes, mesh)), \
            (shape, axes)


@pytest.mark.parametrize("mesh_name", ["2x16x16", "2x2", "4x1"])
def test_opt_state_specs_follow_the_reference(shapes, ref_specs, mesh_name):
    from repro.launch.steps import make_optimizer as j_make_optimizer
    from repro.launch.steps import train_policy

    j_param_shardings, j_opt_state_shardings = ref_specs
    mesh = _mesh(MESHES[mesh_name])
    factored_seen = False
    for arch, tree in shapes.items():
        cfg = j_get_config(arch)
        zero = train_policy(cfg)["fsdp"]
        j_opt = jax.eval_shape(j_make_optimizer(cfg).init, tree)
        want = j_opt_state_shardings(j_opt, j_param_shardings(tree, mesh, fsdp=zero), mesh)
        opt = OptState(step=0, m=_stand_ins(j_opt.m), v=jax.tree_util.tree_map(
            lambda s: types.SimpleNamespace(shape=tuple(s.shape)), j_opt.v))
        got = opt_state_shardings(opt, param_shardings(_stand_ins(tree), mesh, fsdp=zero), mesh)
        assert tuple(got.step.spec) == tuple(want.step.spec) == ()
        for field in ("m", "v"):
            w, g = _paths(getattr(want, field)), _paths(getattr(got, field))
            assert w.keys() == g.keys(), (arch, field)
            for path in w:
                if isinstance(w[path], tuple):  # a factored (row, col) pair
                    factored_seen = True
                    assert [tuple(s.spec) for s in g[path]] == [tuple(s.spec) for s in w[path]]
                else:
                    assert tuple(g[path].spec) == tuple(w[path].spec), (arch, field, path)
    assert factored_seen  # kimi-k2's factored second moment


def test_shard_is_the_identity_and_layouts_follow_specs():
    x = torch.arange(6.0).reshape(2, 3)
    assert shard(x, "dp", None) is x
    mesh = _mesh({"pod": 2, "data": 2, "model": 1})
    spec = param_shardings({"layers": {"wq": torch.zeros(3, 8, 4, 2)}}, mesh,
                           fsdp="pods")["layers"]["wq"].spec
    assert tuple(spec) == (None, ("data", "pod"), "model", None)
    assert fsdp.spec_layout(spec, (3, 8, 4, 2), mesh) == fsdp.Layout(1, ("data", "pod"), 8)
    # the factored moments drop the reduced dim, as opt_state_shardings does
    lay = lambda dim: fsdp.Layout(dim, ("data",), 8)  # noqa: E731
    assert fsdp.factored_layouts(lay(2), 3) == (None, lay(1))  # the columns split
    assert fsdp.factored_layouts(lay(2), 4) == (lay(2), None)  # the rows split
    assert fsdp.factored_layouts(lay(1), 4) == (lay(1), lay(1))  # a leading dim
    assert fsdp.factored_layouts(None, 4) == (None, None)


def test_train_step_needs_a_data_mesh_for_fsdp_configs():
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import make_optimizer, make_train_step, train_policy

    cfg = get_config("gemma3-12b")
    assert train_policy(cfg)["fsdp"] is True
    opt = make_optimizer(cfg)
    with pytest.raises(NotImplementedError, match="use_mesh"):
        make_train_step(cfg, opt)
    with use_mesh(Mesh(("data", "model"), {"data": 2, "model": 1}), fsdp=True):
        assert callable(make_train_step(cfg, opt))
    # a described mesh with data 1 holds no data axis either
    with use_mesh(Mesh(("data", "model"), {"data": 1, "model": 1}), fsdp=True):
        with pytest.raises(NotImplementedError, match="need fsdp"):
            make_train_step(cfg, opt)


def test_a_model_axis_over_one_raises():
    from repro_torch.launch.steps import make_optimizer, make_train_step

    cfg = get_config("gemma3-12b")
    with use_mesh(make_production_mesh(), fsdp=True):
        with pytest.raises(NotImplementedError, match="tensor parallelism"):
            make_train_step(cfg, make_optimizer(cfg))
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        fsdp.shard_params({"wq": torch.zeros(4, 2, 2)}, _mesh({"data": 2, "model": 2}), True)


@pytest.mark.parametrize("dispatch", ["dense", "ws"])
def test_a_batch_that_splits_a_moe_group_raises(dispatch):
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import init_params, moe_ffn_dispatch

    cfg = get_config("kimi-k2-1t-a32b", smoke=True).replace(n_layers=1, moe_dispatch=dispatch)
    p = {k: v[0] for k, v in init_params(cfg, seed=0, device="cpu")["layers"]["moe"].items()}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 512, cfg.d_model)).astype(np.float32))
    y, _ = moe_ffn_dispatch(x, p, cfg)  # one rank: a group of 512 tokens
    assert torch.isfinite(y).all()
    with use_mesh(Mesh(("data", "model"), {"data": 2, "model": 1})):
        # the global batch is 1024 tokens, one group: it would span both ranks
        with pytest.raises(ValueError, match="may not split across ranks"):
            moe_ffn_dispatch(x, p, cfg)
        assert fsdp.moe_group(1024, 1024) == 1024 and fsdp.moe_group(2048, 1024) == 1024
    with use_mesh(Mesh(("pod", "data", "model"), {"pod": 2, "data": 2, "model": 1})):
        with pytest.raises(ValueError, match="may not split across ranks"):
            fsdp.moe_group(512, 1024)


def test_rows_that_do_not_split_over_the_ranks_raise():
    from repro_torch.launch.mesh import Mesh

    with use_mesh(Mesh(("data", "model"), {"data": 2, "model": 1})):
        with pytest.raises(ValueError, match="do not split"):
            fsdp.dp_rows(torch.zeros(3, 4))
    x = torch.zeros(3, 4)
    assert fsdp.dp_rows(x) is x and fsdp.dp_size() == 1
