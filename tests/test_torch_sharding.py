"""The port's sharding rules (``repro_torch.parallel.sharding``), the
families' logical axes and the serve/train sharding helpers, held to the
JAX package's as tuples, exactly: every arch on the production meshes
(16x16, 2x16x16) and two small ones ((2, 2), (1, 3)).  The JAX side
builds ``AbstractMesh``es (no devices needed); the port's meshes are
logical."""
import pytest
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.models import registry as jreg
from repro.parallel import sharding as jshd
from repro.serve import step as jserve
from repro.train import step as jtrain
from repro_torch import configs as tconfigs
from repro_torch.launch.mesh import LogicalMesh, make_test_mesh
from repro_torch.models import registry as treg
from repro_torch.parallel import sharding as tshd
from repro_torch.serve import step as tserve
from repro_torch.train import step as ttrain

ARCHS = jconfigs.ARCHS
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x3": ((1, 3), ("data", "model"))}
BATCHES = (1, 4, 6)
MAX_LEN = 96


def _meshes(name):
    sizes, names = MESHES[name]
    return AbstractMesh(sizes, names), LogicalMesh(names, sizes)


def _jax_specs(tree):
    """A JAX tree of ``NamedSharding``s as nested dicts of spec tuples."""
    if isinstance(tree, dict):
        return {k: _jax_specs(v) for k, v in tree.items()}
    return tuple(tree.spec)


def _port_specs(tree):
    if isinstance(tree, dict):
        return {k: _port_specs(v) for k, v in tree.items()}
    assert isinstance(tree, tshd.Sharding)
    return tree.spec


def test_make_test_mesh_is_logical_at_any_size():
    m = make_test_mesh(data=2, model=3)
    assert (m.axis_names, m.shape, m.devices.size) == (
        ("data", "model"), {"data": 2, "model": 3}, 6)
    assert m.devices.shape == (2, 3)
    p = make_test_mesh(4, 2, pod=2)
    assert p.axis_names == ("pod", "data", "model") and p.devices.size == 16
    # the production meshes: the JAX package's axes and sizes
    from repro_torch.launch.mesh import make_production_mesh
    for multi_pod in (False, True):
        got = make_production_mesh(multi_pod=multi_pod)
        sizes = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
        assert (got.axis_names, got.sizes) == (axes, sizes)
        assert got.devices.shape == sizes
        want = AbstractMesh(sizes, axes)
        assert (got.axis_names, got.shape) == (want.axis_names,
                                               dict(want.shape))
    with pytest.raises(ValueError, match="at least 1"):
        make_test_mesh(data=0)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_specs_equal_jax(arch, mesh_name):
    """``logical_axes`` and ``cache_axes`` through ``spec_from_axes`` with
    each leaf's shape, ``train_state_shardings``, and ``serve_rules`` and
    ``cache_shardings`` at batches 1, 4 and 6."""
    jm, tm = _meshes(mesh_name)
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    jaxes, taxes = jreg.logical_axes(jcfg), treg.logical_axes(tcfg)
    assert taxes == jaxes
    assert treg.cache_axes(tcfg) == jreg.cache_axes(jcfg)
    jp, jo = jtrain.train_state_shardings(jcfg, jm)
    tp, to = ttrain.train_state_shardings(tcfg, tm)
    assert _port_specs(tp) == _jax_specs(jp)
    assert _port_specs(to) == _jax_specs(jo)
    assert _port_specs(tshd.shardings_from_axes(taxes, tm)) == _jax_specs(
        jshd.shardings_from_axes(jaxes, jm))
    # gather_weights_once's TP-only layout (the FSDP dims replicated)
    gathered = dict(jshd.DEFAULT_RULES, embed=None, expert_mlp=None)
    assert _port_specs(ttrain.gathered_shardings(
        tcfg, tm, treg.param_specs(tcfg))) == _jax_specs(
        jshd.shardings_from_axes(jaxes, jm, gathered,
                                 jreg.param_specs(jcfg)))
    for b in BATCHES:
        jr, tr = jserve.serve_rules(jcfg, jm, b), tserve.serve_rules(tcfg, tm,
                                                                      b)
        assert tr == jr
        assert _port_specs(tserve.cache_shardings(tcfg, tm, b, MAX_LEN)) \
            == _jax_specs(jserve.cache_shardings(jcfg, jm, b, MAX_LEN))


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_spec_from_axes_rules_equal_jax(mesh_name):
    """Unknown logical axes, axes the mesh lacks, an axis used twice,
    tuple rules that keep a prefix, divisibility, no shape."""
    jm, tm = _meshes(mesh_name)
    rules = dict(jshd.DEFAULT_RULES, both=("pod", "data", "model"),
                 dm=("data", "model"), missing="nope")
    cases = [(("embed", "heads", None), (96, 32, 128)),
             (("batch", "kv_seq", "kv", None), (6, 96, 8, 64)),
             (("both", "embed"), (64, 48)), (("dm", "mlp"), (6, 7)),
             (("missing", "unknown", "layer"), (4, 4, 4)),
             (("heads", "kv"), (32, 32)), (("expert", None), (3, 9))]
    for axes, shape in cases:
        for shp in (shape, None):
            want = tuple(jshd.spec_from_axes(axes, jm, rules, shp))
            assert tshd.spec_from_axes(axes, tm, rules, shp) == want, (
                axes, shp)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_spec_and_size_of_spec_equal_jax(mesh_name):
    jm, tm = _meshes(mesh_name)
    for ndim in (1, 2, 3):
        assert tshd.batch_spec(tm, ndim) == tuple(jshd.batch_spec(jm, ndim))
        assert tshd.batch_sharding(tm, ndim).spec == tuple(
            jshd.batch_sharding(jm, ndim).spec)
    specs = {"tokens": (6, 128), "frontend_embeds": (6, 64, 32)}
    got = ttrain.batch_shardings(None, tm, specs)
    assert {k: v.spec for k, v in got.items()} == {
        k: tshd.batch_spec(tm, len(s)) for k, s in specs.items()}
    from jax.sharding import PartitionSpec as P
    for spec, shape in [((), (4, 4)), (("data", None), (32, 8)),
                        ((("data", "model"), None), (64, 3)),
                        ((None, "model"), (5, 48)),
                        (("model", "data"), (48, 32))]:
        if any(a not in tm.axis_names for e in spec if e
               for a in ((e,) if isinstance(e, str) else e)):
            continue
        assert tshd.size_of_spec(spec, shape, tm) == jshd.size_of_spec(
            P(*spec), shape, jm)


def test_shardings_from_axes_needs_matching_trees():
    tm = make_test_mesh(2, 2)
    with pytest.raises(ValueError, match="structure"):
        tshd.shardings_from_axes({"a": ("embed",), "b": (None,)}, tm,
                                 spec_tree={"a": (4,)})
    sh = tshd.shardings_from_axes({"a": ("embed",), "n": ()}, tm,
                                  spec_tree={"a": (4,), "n": ()})
    assert sh == {"a": tshd.Sharding(tm, ("data",)),
                  "n": tshd.Sharding(tm, ())}
