"""The port's sharding rules and spec trees against the reference's,
called live.

- `sharding.rules`: the logical table, `spec`, `batch_spec`,
  `member_spec`, `segment_member_spec`, the `ACT_*` specs and the axis
  sizes, exactly; `sanitize_spec` on every spec tree below, in both
  parallelism modes and under both production meshes' axis names,
  exactly.
- Parameter spec trees of every family (its reduced config and its
  published one) against the reference's `LM.abstract_init`, entry by
  entry, and the meta parameter tree's shapes and types against the
  reference's ShapeDtypeStructs; `cache_specs` both ways;
  `opt_state_specs` for AdamW and Adafactor.
- Kimi K2's full `abstract_init` allocates nothing (meta tensors only)
  and describes more than 9e11 parameters, every spec a
  `PartitionSpec`: the counterpart of
  tests/test_tpu_model.py::test_abstract_init_allocates_nothing.

A test that sets a parallelism mode restores "tp" in both packages in a
`finally`: the mode is a module global.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCH_IDS, get_config as R_get_config
from repro.models.lm import build_model as R_build_model
from repro.sharding import rules as R
from repro.train import train_step as R_ts
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.lm import build_model, param_specs
from repro_torch.sharding import rules as T
from repro_torch.train import train_step as T_ts

LOGICAL = [name for name in R.LOGICAL_RULES]
MESH_AXES = {name: set(make_production_mesh(multi_pod=mp))
             for name, mp in (("16x16", False), ("2x16x16", True))}


def _flat(tree, prefix=""):
    """{path: spec as a plain tuple} of a nested dict of specs (either
    package's PartitionSpec)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    assert isinstance(tree, (JP, T.PartitionSpec)), (prefix, tree)
    return {prefix: tuple(tree)}


@pytest.fixture(scope="module")
def ref_trees():
    """{(arch, reduced): (ShapeDtypeStruct tree, spec tree)} of the
    reference's abstract init."""
    out = {}
    for arch in ARCH_IDS:
        for reduced in (True, False):
            model = R_build_model(R_get_config(arch, reduced=reduced))
            out[arch, reduced] = model.abstract_init(jax.random.PRNGKey(0))
    return out


def test_logical_rules_and_axis_sizes_equal_the_reference():
    assert T.LOGICAL_RULES == R.LOGICAL_RULES
    assert list(T.LOGICAL_RULES) == list(R.LOGICAL_RULES)
    assert (T.POD_AXIS_SIZE, T.DATA_AXIS_SIZE, T.MODEL_AXIS_SIZE,
            T.POP_AXIS) == (R.POD_AXIS_SIZE, R.DATA_AXIS_SIZE,
                            R.MODEL_AXIS_SIZE, R.POP_AXIS)


@pytest.mark.parametrize("names", [(n,) for n in LOGICAL]
                         + [("embed", "mlp"), ("experts", "embed",
                                               "expert_mlp"),
                            ("batch", "seq", "vocab"), ()])
def test_spec_equals_the_reference(names):
    got, want = T.spec(*names), R.spec(*names)
    assert isinstance(got, T.PartitionSpec)
    assert tuple(got) == tuple(want)


@pytest.mark.parametrize("extra", [0, 1, 2, 3])
def test_batch_and_member_specs_equal_the_reference(extra):
    for name in ("batch_spec", "member_spec", "segment_member_spec"):
        assert tuple(getattr(T, name)(extra)) == \
            tuple(getattr(R, name)(extra)), name


@pytest.mark.parametrize("name", ["ACT_TOKENS", "ACT_TOKENS_TP",
                                  "ACT_Q_ULYSSES", "ACT_KV_GATHERED",
                                  "ACT_KV_DECODE", "ACT_GROUPS"])
def test_activation_specs_equal_the_reference(name):
    assert tuple(getattr(T, name)) == tuple(getattr(R, name))


def test_partition_spec_is_a_tuple_of_its_entries():
    s = T.PartitionSpec(("pod", "data"), None, "model")
    assert isinstance(s, tuple) and len(s) == 3
    assert s == (("pod", "data"), None, "model")
    assert T.PartitionSpec() == () and repr(T.PartitionSpec("a")) == \
        "PartitionSpec('a',)"
    with pytest.raises(ValueError, match="parallelism"):
        T.set_parallelism("pp")


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("reduced", [True, False],
                         ids=["reduced", "published"])
def test_param_specs_equal_the_reference(arch, reduced, ref_trees):
    want = _flat(ref_trees[arch, reduced][1])
    got = _flat(param_specs(get_config(arch, reduced=reduced)))
    assert got == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_init_matches_the_reference_shapes(arch, ref_trees):
    """The meta tree has the reference's leaves, shapes and types, and
    `LM.abstract_init`'s specs are `param_specs`."""
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg, device="meta")
    params, specs = model.abstract_init()
    shapes = ref_trees[arch, True][0]
    want = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_leaves_with_path(shapes)}

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}['{k}']")
        else:
            yield prefix, tree

    got = {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for p, t in leaves(params)}
    assert got == want
    assert all(t.device.type == "meta" for _, t in leaves(params))
    assert _flat(specs) == _flat(param_specs(cfg))
    assert all(p.device.type == "meta" for p in model.parameters())


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "jamba_v0_1_52b",
                                  "mamba2_1_3b", "llama_3_2_vision_90b"])
@pytest.mark.parametrize("shardable", [True, False])
def test_cache_specs_equal_the_reference(arch, shardable):
    cfg = get_config(arch, reduced=True)
    want = R_build_model(R_get_config(arch, reduced=True)).cache_specs(
        batch_shardable=shardable)
    got = build_model(cfg, device="meta").cache_specs(
        batch_shardable=shardable)
    assert _flat(got) == _flat(want)


@pytest.mark.parametrize("opt", ["adam", "adafactor"])
@pytest.mark.parametrize("arch", ["qwen3_0_6b", "kimi_k2_1t",
                                  "jamba_v0_1_52b"])
def test_opt_state_specs_equal_the_reference(opt, arch, ref_trees):
    want = R_ts.opt_state_specs(ref_trees[arch, True][1], opt)
    got = T_ts.opt_state_specs(param_specs(get_config(arch, reduced=True)),
                               opt)
    assert _flat(got) == _flat(want)


@pytest.mark.parametrize("opt", ["adam", "adafactor"])
def test_opt_state_specs_are_congruent_with_the_state(opt):
    """Every leaf of the port's optimizer state (`make_optimizer`'s
    init, on meta parameters) has a spec of its rank, and no spec lacks
    a leaf."""
    from repro_torch.train.optimizer import OptConfig, make_optimizer

    cfg = get_config("jamba_v0_1_52b", reduced=True)
    model = build_model(cfg, device="meta")
    init_opt, _ = make_optimizer(opt, OptConfig())
    state = init_opt(OptConfig(), model.params)
    specs = T_ts.opt_state_specs(param_specs(cfg), opt)

    def pair(s, sp, path=""):
        if isinstance(s, dict):
            assert set(s) == set(sp), path
            for k in s:
                yield from pair(s[k], sp[k], f"{path}/{k}")
        else:
            yield path, s, sp

    pairs = list(pair(state, specs))
    assert pairs and all(t.dim() == len(sp) or len(sp) == 0
                         for _, t, sp in pairs)


def _spec_trees():
    """Every spec tree of the dry-run: parameters of each family
    (published), the caches both ways, AdamW and Adafactor state, the
    batch specs, the activation specs."""
    trees = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        trees[f"params:{arch}"] = param_specs(cfg)
        trees[f"opt:{arch}"] = T_ts.opt_state_specs(param_specs(cfg),
                                                    cfg.optimizer)
    for shardable in (True, False):
        for arch in ("qwen3_0_6b", "jamba_v0_1_52b"):
            trees[f"cache:{arch}:{shardable}"] = build_model(
                get_config(arch, reduced=True), device="meta").cache_specs(
                batch_shardable=shardable)
    trees["act"] = {n: getattr(T, n) for n in (
        "ACT_TOKENS", "ACT_TOKENS_TP", "ACT_Q_ULYSSES", "ACT_KV_GATHERED",
        "ACT_KV_DECODE", "ACT_GROUPS")}
    trees["batch"] = {str(n): T.batch_spec(n) for n in range(3)}
    return trees


def _as_ref(tree):
    if isinstance(tree, dict):
        return {k: _as_ref(v) for k, v in tree.items()}
    return JP(*tree)


@pytest.mark.parametrize("mode", ["tp", "dp"])
@pytest.mark.parametrize("mesh", sorted(MESH_AXES))
def test_sanitize_spec_equals_the_reference(mode, mesh):
    names = MESH_AXES[mesh]
    try:
        T.set_parallelism(mode)
        R.set_parallelism(mode)
        for key, tree in _spec_trees().items():
            got = {p: tuple(T.sanitize_spec(T.PartitionSpec(*s), names))
                   for p, s in _flat(tree).items()}
            want = {p: tuple(R.sanitize_spec(JP(*s), names))
                    for p, s in _flat(_as_ref(tree)).items()}
            assert got == want, key
    finally:
        T.set_parallelism("tp")
        R.set_parallelism("tp")


def test_kimi_abstract_init_allocates_nothing():
    cfg = get_config("kimi_k2_1t")
    model = build_model(cfg, device="meta")
    params, specs = model.abstract_init()

    def leaves(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                yield from leaves(v)
        else:
            yield tree

    tensors = list(leaves(params))
    assert all(isinstance(t, torch.Tensor) and t.device.type == "meta"
               for t in tensors)
    total = sum(int(np.prod(t.shape)) for t in tensors)
    assert total > 9e11
    assert all(isinstance(s, T.PartitionSpec) for s in leaves(specs))
    assert sum(p.numel() for p in model.parameters()) == total
