"""The port's sharding rules (``repro_torch.runtime.sharding``) against
``repro.runtime.sharding``, spec for spec with ``==``: every arch of the
registry, every shape of ``shapes_for``, on the single-pod mesh {data
16, model 16} and the two-pod mesh {pod 2, data 16, model 16}.

The reference reads only ``mesh.shape``, so a namespace with that
mapping drives it without 256 JAX devices; the port takes the mapping
itself.  The reference's trees come from ``jax.eval_shape``, the port's
from ``init_params(..., device="meta")``, ``input_specs`` and
``init_cache(..., device="meta")``.  A reference ``PartitionSpec`` is
compared as a tuple.  The port's K / V cache leaves are head-major, so
their specs are compared with the time and head entries swapped back
into the reference's order.
"""

import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.runtime import sharding as jshd  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.configs.registry import _ctx_len, _dec_len  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.runtime import sharding as tshd  # noqa: E402

pytestmark = pytest.mark.torch

MESHES = {"pod16x16": {"data": 16, "model": 16},
          "pod2x16x16": {"pod": 2, "data": 16, "model": 16}}
CELLS = [(arch, shape.name) for arch in tcfgs.ARCHS
         for shape in tcfgs.shapes_for(tcfgs.get(arch))]

_REF_PARAMS = {}


def _ref_params(arch):
    if arch not in _REF_PARAMS:
        cfg = jcfgs.get(arch)
        _REF_PARAMS[arch] = jax.eval_shape(
            lambda k: jtf.init_params(cfg, k), jax.random.PRNGKey(0))
    return _REF_PARAMS[arch]


def _ref_mesh(axes):
    return types.SimpleNamespace(shape=dict(axes))


def _ref_flat(tree):
    """path -> the spec as a tuple, of a reference spec tree."""
    return {p: tuple(s) for p, s in jshd._flatten_with_paths(tree)}


def _port_flat(tree, head_major=False):
    """path -> spec of a port spec tree; with ``head_major``, K / V
    specs with their time and head entries in the reference's order."""
    out = {}
    for p, s in tshd.flatten_with_paths(tree):
        if head_major and p.rsplit("/", 1)[-1] in tshd.HEAD_MAJOR:
            s = s[:-3] + (s[-2], s[-3], s[-1])
        out[p] = s
    return out


def _assert_same(port: dict, ref: dict):
    assert port.keys() == ref.keys()
    bad = {p: (port[p], ref[p]) for p in ref if port[p] != ref[p]}
    assert not bad, bad


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(tcfgs.ARCHS))
def test_param_and_optimizer_specs_match_reference(arch, mesh):
    axes = MESHES[mesh]
    jp = _ref_params(arch)
    tp = ttf.init_params(tcfgs.get(arch), device="meta")
    jm = _ref_mesh(axes)
    _assert_same(_port_flat(tshd.param_specs(tp)),
                 _ref_flat(jshd.param_specs(jp)))
    _assert_same(_port_flat(tshd.fsdp_param_specs(tp, axes)),
                 _ref_flat(jshd.fsdp_param_specs(jp, jm)))
    for zero in (True, False):
        _assert_same(_port_flat(tshd.opt_state_specs(tp, axes, zero)),
                     _ref_flat(jshd.opt_state_specs(jp, jm, zero)))
    assert tshd.dp_axes(axes) == jshd.dp_axes(jm)


def _ref_cache(cfg, b, s, ctx):
    return jax.eval_shape(lambda: jtf.init_cache(cfg, b, s, ctx_len=ctx))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_batch_and_cache_specs_match_reference(arch, shape, mesh):
    """Train and prefill batches (train also pre-split into 2
    microbatches, ``batch_dim`` 1), the prefill's cache as the dry-run
    builds it, and the decode cache of ``input_specs``."""
    axes = MESHES[mesh]
    jm = _ref_mesh(axes)
    jc, tc = jcfgs.get(arch), tcfgs.get(arch)
    shp = tcfgs.SHAPES[shape]
    jspecs, tspecs = (jcfgs.input_specs(jc, jcfgs.SHAPES[shape]),
                      tcfgs.input_specs(tc, shp))
    if shp.kind == "decode":
        _assert_same(
            _port_flat(tshd.cache_specs(tspecs["cache"], tc, axes), True),
            _ref_flat(jshd.cache_specs(jspecs["cache"], jc, jm)))
        jtok = jax.ShapeDtypeStruct(tuple(jspecs["token"].shape), "int32")
        _assert_same(_port_flat(tshd.batch_specs(
            {"token": tspecs["token"]}, axes)),
            _ref_flat(jshd.batch_specs({"token": jtok}, jm)))
        return
    _assert_same(_port_flat(tshd.batch_specs(tspecs, axes)),
                 _ref_flat(jshd.batch_specs(jspecs, jm)))
    if shp.kind == "train":
        def split(x):
            return (2, x.shape[0] // 2) + tuple(x.shape[1:])
        tsplit = {k: torch.empty(split(v), device="meta")
                  for k, v in tspecs.items()}
        jsplit = {k: jax.ShapeDtypeStruct(split(v), v.dtype)
                  for k, v in jspecs.items()}
        _assert_same(_port_flat(tshd.batch_specs(tsplit, axes, 1)),
                     _ref_flat(jshd.batch_specs(jsplit, jm, 1)))
        return
    b, s = shp.global_batch, _dec_len(tc, shp.seq_len)
    ctx = (tc.vision.n_image_tokens if tc.family == "vlm"
           else shp.seq_len if tc.family == "audio" else 0)
    tcache = ttf.init_cache(tc, b, s, ctx_len=ctx, device="meta")
    _assert_same(_port_flat(tshd.cache_specs(tcache, tc, axes), True),
                 _ref_flat(jshd.cache_specs(_ref_cache(jc, b, s, ctx), jc,
                                            jm)))


def test_an_unstacked_prefix_cache_shards_time_over_data():
    """The reference's index-1-is-batch rule, kept: deepseek-v2-lite's
    dense first layer's latent cache (B, T, rank) at prefill_32k has its
    time dim split over 'data'."""
    tc = tcfgs.get("deepseek-v2-lite-16b")
    cache = ttf.init_cache(tc, 128, 32768, device="meta")
    specs = tshd.cache_specs(cache, tc, MESHES["pod16x16"])
    assert tuple(cache["prefix_0"]["ckv"].shape) == (128, 32768, 512)
    assert specs["prefix_0"]["ckv"] == (None, "data", None)


@pytest.mark.parametrize("spec,shape,want", [
    ((), (64, 48), ("data", None)),
    ((None, "model"), (48, 64), ("data", "model")),
    (("model", None), (64, 8), ("model", None)),      # nothing divides
    ((None,), (32, 64), (None, "data")),              # padded, largest
    ((), (7,), ()),
])
def test_zero_spec_matches_reference(spec, shape, want):
    axes = {"data": 16, "model": 16}
    assert tshd.zero_spec(spec, shape, axes) == want
    assert tuple(jshd.zero_spec(jax.sharding.PartitionSpec(*spec), shape,
                                _ref_mesh(axes))) == want


def test_local_shape_divides_each_entry():
    axes = MESHES["pod2x16x16"]
    assert tshd.local_shape((("pod", "data"), None, "model"),
                            (64, 5, 32), axes) == (2, 5, 2)
    assert tshd.local_shape((), (3, 4), axes) == (3, 4)
