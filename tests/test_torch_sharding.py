"""Port parity of the sharding specs and dry-run shapes: the port's
``distributed/sharding.py`` (``ShardingRules``, ``rules_for_mesh``,
``is_spec_leaf``, ``map_specs``, ``constrain``), every ``*_specs``
function, ``ModelAPI.param_specs``/``cache_specs``, ``opt_state_specs``,
``train_state_specs``, the LM shapes and mesh shapes of ``config/core.py``,
and ``input_specs``/``cache_struct``/``param_struct``, each held to the
JAX package's on the CPU.

The spec trees are pure Python, so they compare for equality.  The structs
compare in shape and dtype at full width: the port's are meta tensors, the
reference's ``jax.eval_shape`` results, and neither side allocates.  On
reduced configs the spec trees also take the structure of the params, the
caches and the train state the port actually draws on the CPU."""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.config as jconfig  # noqa: E402
import repro.distributed.sharding as jsharding  # noqa: E402
import repro.models.api as japi  # noqa: E402
import repro.optim as joptim  # noqa: E402
import repro.training.step as jstep  # noqa: E402
import repro_torch.config as tconfig  # noqa: E402
import repro_torch.distributed.sharding as sharding  # noqa: E402
import repro_torch.models.api as tapi  # noqa: E402
import repro_torch.optim as toptim  # noqa: E402
import repro_torch.training.step as tstep  # noqa: E402
from repro_torch.engine.placement import make_mesh  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402

# parity with the reference: its archs (the port's own moonlight-16b-a3b has
# no counterpart; tests/test_torch_moonlight.py holds its structs)
ARCHS = jconfig.list_archs()
SIZES = ("full", "reduced")
LOGICAL = (None, "batch", "sp", "tp", "expert", "fsdp", "tokens")
TRAIN_CONFIGS = (tconfig.TrainConfig(), tconfig.TrainConfig(grad_compression="int8_ef"))


def _cfgs(arch: str, size: str):
    if size == "full":
        return jconfig.get_config(arch), tconfig.get_config(arch)
    return jconfig.reduced_config(arch), tconfig.reduced_config(arch)


def _plain(tree):
    """A spec tree with its dataclass containers (AdamWState, TrainState)
    as (class name, fields): trees of the two packages compare with ==."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return (type(tree).__name__,
                {f.name: _plain(getattr(tree, f.name)) for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_plain(v) for v in tree]
    if isinstance(tree, tuple) and not sharding.is_spec_leaf(tree):
        return tuple(_plain(v) for v in tree)
    return tree


def _flat(tree, path="") -> dict:
    """path -> leaf of a tree of dicts, sequences and dataclasses."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in _flat(tree[key], f"{path}/{key}").items()}
    if isinstance(tree, (tuple, list)) and not sharding.is_spec_leaf(tree):
        return {k: v for i, x in enumerate(tree) for k, v in _flat(x, f"{path}[{i}]").items()}
    return {path: tree}


def _shapes(tree) -> dict:
    """path -> (shape, dtype name) of a struct or tensor tree."""
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in _flat(tree).items() if v is not None}


def test_port_archs_are_the_references_plus_moonlight():
    assert tconfig.list_archs() == sorted(ARCHS + ["moonlight-16b-a3b"])


# -- ShardingRules and the helpers --------------------------------------------


def _ref_mesh(axes):
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape((1,) * len(axes)), axes)


@pytest.mark.parametrize("axes", [("data", "model"), ("pod", "data", "model")],
                         ids=["no-pod-axis", "pod-axis"])
def test_rules_for_mesh_and_spec_match_the_reference(axes):
    mine = sharding.rules_for_mesh(make_mesh((1,) * len(axes), axes, ["cpu"]))
    ref = jsharding.rules_for_mesh(_ref_mesh(axes))
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    for a in LOGICAL:
        assert mine.physical(a) == ref.physical(a)
        for b in LOGICAL:
            assert mine.spec((a, b)) == tuple(ref.spec((a, b)))
    assert mine.spec(()) == tuple(ref.spec(())) == ()
    with pytest.raises(KeyError, match="unknown logical axis"):
        mine.spec(("heads",))
    with pytest.raises(KeyError, match="unknown logical axis"):
        ref.spec(("heads",))


@pytest.mark.parametrize("value", [
    (), ("tp",), ("tp", None), (None, None, "fsdp"), ({"w": ("tp",)},),
    (("tp",), ("fsdp",)), ["tp"], "tp", None, {"w": ("tp",)}, (1,),
])
def test_is_spec_leaf_matches_the_reference(value):
    assert sharding.is_spec_leaf(value) == jsharding.is_spec_leaf(value)


def test_map_specs_matches_the_reference():
    tree = {"a": ("tp", None), "b": ({"c": (None,)}, ("fsdp",)), "e": (),
            "n": None, "l": [("batch",), {"d": ("expert", None, "fsdp")}]}
    fn = lambda axes: (None,) + axes  # noqa: E731
    assert sharding.map_specs(fn, tree) == jsharding.map_specs(fn, tree)
    state = toptim.opt_state_specs(tree)
    mapped = sharding.map_specs(fn, state)
    assert _plain(mapped) == _plain(jsharding.map_specs(fn, joptim.opt_state_specs(tree)))
    assert mapped.step == (None,)


def test_constrain_checks_rank_and_is_a_no_op_without_a_mesh(tmp_path):
    """Without a mesh ``constrain`` is ``x`` itself; under a mesh (one gloo
    rank, (1, 1)) it checks the rank and places ``x`` by the spec."""
    from test_torch_sharded_step import one_rank_mesh
    from torch.distributed.tensor import Replicate

    x = torch.zeros(2, 3)
    assert sharding.constrain(x, ("batch", None)) is x
    assert sharding.constrain(x, ("batch",)) is x      # no mesh: no check, as the reference
    assert sharding.active_mesh() is None and sharding.active_rules() is None
    assert sharding.rules_for_mesh(make_mesh((1, 1), ("data", "model"), ["cpu"])) == \
        sharding.ShardingRules()
    with one_rank_mesh(tmp_path) as mesh, sharding.mesh_context(mesh):
        assert sharding.active_mesh() is mesh
        assert sharding.active_rules() == sharding.ShardingRules()
        with pytest.raises(ValueError, match="does not match rank-2"):
            sharding.constrain(x, ("batch",))
        placed = sharding.constrain(x, ("batch", "tp"))
        # each axis of size 1 holds the whole dim, as Replicate
        assert tuple(placed.placements) == sharding.named_sharding(
            mesh, sharding.ShardingRules(), ("batch", "tp")) == (Replicate(), Replicate())
        assert torch.equal(placed.full_tensor(), x)
        with sharding.mesh_context(None):
            assert sharding.constrain(x, ("batch",)) is x
        assert sharding.active_mesh() is mesh
    assert sharding.active_mesh() is None
    # the reference's rank check, under a mesh of its own
    with jsharding.mesh_context(_ref_mesh(("data", "model"))):
        with pytest.raises(ValueError, match="does not match rank-2"):
            jsharding.constrain(jax.numpy.zeros((2, 3)), ("batch",))


# -- config: shapes and meshes -------------------------------------------------


def test_lm_shapes_and_meshes_match_the_reference():
    for name in ("TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K", "SINGLE_POD",
                 "MULTI_POD"):
        assert dataclasses.asdict(getattr(tconfig, name)) == \
            dataclasses.asdict(getattr(jconfig, name)), name
    assert [dataclasses.asdict(s) for s in tconfig.LM_SHAPES] == \
        [dataclasses.asdict(s) for s in jconfig.LM_SHAPES]
    for mesh in ("SINGLE_POD", "MULTI_POD"):
        assert getattr(tconfig, mesh).num_devices == getattr(jconfig, mesh).num_devices
    assert [s.is_train for s in tconfig.LM_SHAPES + tconfig.LSTMAE_SHAPES] == \
        [s.is_train for s in jconfig.LM_SHAPES + jconfig.LSTMAE_SHAPES]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_for_matches_the_reference(arch, size):
    jcfg, tcfg = _cfgs(arch, size)
    assert [dataclasses.asdict(s) for s in tconfig.shapes_for(tcfg)] == \
        [dataclasses.asdict(s) for s in jconfig.shapes_for(jcfg)]


# -- every *_specs function ----------------------------------------------------


def _spec_calls(jcfg, tcfg):
    """(module, function, reference args, port args) of every ``*_specs``
    function that the config's family reaches."""
    both = lambda *a: (a, a)  # noqa: E731
    calls = [("layers.linear", "linear_specs", *both(i, o, b))
             for i in (None, "fsdp", "tp") for o in (None, "tp", "fsdp") for b in (False, True)]
    calls += [("layers.norms", "norm_specs", *both(k))
              for k in ("rmsnorm", "layernorm", "nonparametric_ln")]
    calls += [("layers.embeddings", "embedding_specs", *both()),
              ("layers.embeddings", "unembed_specs", *both()),
              ("layers.attention", "kv_cache_specs", *both()),
              ("layers.mamba", "mamba_state_specs", *both()),
              ("core.lstm", "lstm_cell_specs", *both()),
              ("models.rwkv6", "state_specs", *both())]
    cfg = ((jcfg,), (tcfg,))
    fam = tcfg.family
    if fam == "lstm_ae":
        return calls + [("core.lstm", "lstm_ae_specs", *cfg)]
    calls += [("layers.mlp", "mlp_specs", *cfg), ("layers.attention", "attention_specs", *cfg)]
    if tcfg.moe is not None:
        calls.append(("layers.moe", "moe_specs", *cfg))
    if fam == "transformer":
        calls += [("models.transformer", f, *cfg)
                  for f in ("layer_specs", "transformer_specs", "decode_cache_specs")]
        unrolled = (jcfg.with_overrides(decode_loop="unroll"),), \
            (tcfg.with_overrides(decode_loop="unroll"),)
        calls.append(("models.transformer", "decode_cache_specs", *unrolled))
    elif fam == "rwkv6":
        calls += [("layers.rwkv", "time_mix_specs", *cfg),
                  ("layers.rwkv", "channel_mix_specs", *cfg),
                  ("models.rwkv6", "layer_specs", *cfg), ("models.rwkv6", "rwkv6_specs", *cfg)]
    elif fam == "jamba":
        calls += [("layers.mamba", "mamba_specs", *cfg),
                  ("models.jamba", "jamba_specs", *cfg), ("models.jamba", "state_specs", *cfg)]
        calls += [("models.jamba", "position_specs", (jcfg, j), (tcfg, j)) for j in range(8)]
    elif fam == "whisper":
        calls += [("models.whisper", f, *cfg) for f in
                  ("enc_layer_specs", "dec_layer_specs", "whisper_specs", "decode_cache_specs")]
    return calls


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_every_specs_function_matches_the_reference(arch, size):
    jcfg, tcfg = _cfgs(arch, size)
    for mod, fn, jargs, targs in _spec_calls(jcfg, tcfg):
        ref = getattr(importlib.import_module(f"repro.{mod}"), fn)(*jargs)
        mine = getattr(importlib.import_module(f"repro_torch.{mod}"), fn)(*targs)
        assert _plain(mine) == _plain(ref), f"{mod}.{fn}{targs[1:]}"
    with pytest.raises(ValueError, match="unknown norm kind"):
        importlib.import_module("repro_torch.layers.norms").norm_specs("batchnorm")


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_model_and_train_state_specs_match_the_reference(arch, size):
    jcfg, tcfg = _cfgs(arch, size)
    ref, mine = japi.build_model(jcfg), tapi.build_model(tcfg)
    assert mine.param_specs() == ref.param_specs()
    assert (mine.cache_specs is None) == (ref.cache_specs is None)
    if mine.cache_specs is not None:
        assert mine.cache_specs() == ref.cache_specs()
    ps = mine.param_specs()
    assert _plain(toptim.opt_state_specs(ps)) == _plain(joptim.opt_state_specs(ps))
    for tc in TRAIN_CONFIGS:
        jtc = jconfig.TrainConfig(**dataclasses.asdict(tc))
        assert _plain(tstep.train_state_specs(mine, tc)) == \
            _plain(jstep.train_state_specs(ref, jtc))
    # every axis name is one the rules know
    rules = sharding.ShardingRules()
    for spec in _flat(mine.param_specs()).values():
        rules.spec(spec)


# -- dry-run structs at full width -----------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_structs_match_the_reference_at_full_width(arch):
    jcfg, tcfg = _cfgs(arch, "full")
    ref, mine = japi.build_model(jcfg), tapi.build_model(tcfg)
    params = tapi.param_struct(mine)
    assert all(t.is_meta for t in tree_leaves(params))
    assert _shapes(params) == _shapes(japi.param_struct(ref))
    specs = _flat(mine.param_specs())
    assert specs.keys() == _flat(params).keys()
    for path, t in _flat(params).items():
        assert len(specs[path]) == t.ndim, path
    for shape in tconfig.shapes_for(tcfg):
        jshape = next(s for s in jconfig.shapes_for(jcfg) if s.name == shape.name)
        inputs = tapi.input_specs(tcfg, shape)
        assert all(t.is_meta for t in inputs.values())
        assert _shapes(inputs) == _shapes(japi.input_specs(jcfg, jshape))
        if shape.kind != "decode" and tcfg.family != "lstm_ae":
            continue
        cache = tapi.cache_struct(mine, shape.global_batch, shape.seq_len)
        assert all(t.is_meta for t in tree_leaves(cache))
        assert _shapes(cache) == _shapes(japi.cache_struct(ref, shape.global_batch,
                                                           shape.seq_len))
        if mine.cache_specs is not None:
            cspecs = _flat(mine.cache_specs())
            assert cspecs.keys() == _flat(cache).keys()
            assert all(len(cspecs[p]) == t.ndim for p, t in _flat(cache).items())


def test_input_specs_refuses_a_vision_cell_with_no_text():
    cfg = tconfig.get_config("phi-3-vision-4.2b")
    short = tconfig.ShapeConfig("short", seq_len=cfg.vision_patches, global_batch=1,
                                kind="prefill")
    with pytest.raises(ValueError, match="no text"):
        tapi.input_specs(cfg, short)


# -- spec trees against what the port draws on the CPU -------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_fit_the_params_the_port_draws(arch):
    cfg = tconfig.reduced_config(arch)
    api = tapi.build_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    specs, leaves = _flat(api.param_specs()), _flat(params)
    assert specs.keys() == leaves.keys()
    assert all(len(specs[p]) == t.ndim for p, t in leaves.items())
    assert _shapes(tapi.param_struct(api)) == _shapes(params)
    cache = api.init_cache(2, 16, device="cpu")
    assert _shapes(tapi.cache_struct(api, 2, 16)) == _shapes(cache)
    if api.cache_specs is not None:
        cspecs = _flat(api.cache_specs())
        assert cspecs.keys() == _flat(cache).keys()
        assert all(len(cspecs[p]) == t.ndim for p, t in _flat(cache).items())
    for tc in TRAIN_CONFIGS:
        state = tstep.init_train_state(params, tc)
        # ef is None on both sides without int8_ef
        sspecs = {p: s for p, s in _flat(tstep.train_state_specs(api, tc)).items()
                  if s is not None}
        sleaves = {p: t for p, t in _flat(state).items() if t is not None}
        assert sspecs.keys() == sleaves.keys()
        assert all(len(sspecs[p]) == t.ndim for p, t in sleaves.items())
