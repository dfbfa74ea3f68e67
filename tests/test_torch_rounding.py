"""The port's device rounding (`_round_population_core`) and ordering
coordinate descent (`_cd_orderings`), given the reference's own inputs,
against the reference: integer picks and log-thetas held to exact
equality."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (PORT_SPECS, REF_SPECS, SPEC_NAMES,
                           random_population)
from repro.core import archspec as R_arch
from repro.core import model as R_model
from repro.core import rounding as R_round
from repro.core import search as R_search
from repro.workloads.dnn_zoo import resnet50
from repro_torch.core import archspec as T_arch
from repro_torch.core import rounding as T_round
from repro_torch.core import search as T_search


@pytest.mark.parametrize("cap", [None, 8], ids=["spec_cap", "cap8"])
@pytest.mark.parametrize("name", SPEC_NAMES)
def test_round_population_core_exact(name, cap, tiny_workload):
    rc = R_arch.compile_spec(REF_SPECS[name])
    tc = T_arch.compile_spec(PORT_SPECS[name])
    dims = tiny_workload.dims_array()
    f, orders = random_population(rc, dims, 6, seed=3, continuous=True)
    wide = np.exp(np.random.default_rng(8).normal(0.0, 2.0, f.shape))
    f = np.concatenate([f, (f * wide).astype(np.float32)])
    pe_cap = rc.pe_cap if cap is None else cap
    out_r, th_r = jax.jit(lambda x: R_round._round_population_core(
        rc, R_round.rounding_tables(dims), x, pe_cap))(jnp.asarray(f))
    out_t, th_t = T_round._round_population_core(
        tc, T_round.rounding_tables(dims, "cpu"), torch.from_numpy(f),
        pe_cap)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_r))
    np.testing.assert_array_equal(th_t.numpy(), np.asarray(th_r))
    # ... and the host projection agrees with both.
    host = T_round.round_population(f, np.concatenate([orders, orders]),
                                    dims, pe_cap=pe_cap,
                                    spec=PORT_SPECS[name])
    np.testing.assert_array_equal(
        np.stack([np.stack([m.f for m in ms]) for ms in host]),
        out_t.numpy())


def _ordering_inputs(rc, wl, n, seed):
    """The reference's repeat-scaled (e, lat) tables for a rounded
    population on `wl`, as numpy float32."""
    dims = wl.dims_array()
    f, _ = random_population(rc, dims, n, seed)
    strides = jnp.asarray(wl.strides_array(), dtype=jnp.float32)
    rep = jnp.asarray(wl.repeats_array(), dtype=jnp.float32)[None, :, None]

    @jax.jit
    def tables(fj):
        hws = R_model.infer_hw_population_spec(rc, fj, strides)
        e, lat = R_model.layer_el_all_orderings_population_spec(
            rc, fj, strides, hws)
        return e * rep, lat * rep
    e, lat = tables(jnp.asarray(f))
    return np.asarray(e), np.asarray(lat)


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_cd_orderings_exact(name, tiny_workload):
    rc = R_arch.compile_spec(REF_SPECS[name])
    cases = [_ordering_inputs(rc, tiny_workload, 8, seed=4)]
    if name == "gemmini":
        cases.append(_ordering_inputs(rc, resnet50(), 4, seed=5))
    # Integer-valued tables: many exact ties, first minimum must win.
    rng = np.random.default_rng(6)
    n_combos = len(rc.combos)
    cases.append((rng.integers(1, 4, (5, 6, n_combos)).astype(np.float32),
                  rng.integers(1, 4, (5, 6, n_combos)).astype(np.float32)))
    for e, lat in cases:
        ref = np.asarray(jax.vmap(R_search._cd_orderings)(
            jnp.asarray(e), jnp.asarray(lat)))
        got = T_search._cd_orderings(torch.tensor(e),
                                     torch.tensor(lat)).numpy()
        np.testing.assert_array_equal(got, ref)
