"""End to end on Gemmini: the port's sequential and fused drivers run
the reference's protocol on the tiny 3-layer workload (2 segments, 3
start points through population=2, so a ragged chunk is padded) under
each ordering mode, and report the reference's `best_edp`, `n_evals`,
`start_edps`, `history` and best mappings exactly."""
import pytest

from _torch_parity import assert_search_equal, port_search, reference_search

_REF = {}


def _reference(wl, mode, population):
    key = (mode, population)
    if key not in _REF:
        _REF[key] = reference_search(wl, mode, "gemmini", population)
    return _REF[key]


@pytest.mark.parametrize("population", [None, 2],
                         ids=["sequential", "fused"])
@pytest.mark.parametrize("mode", ["iterative", "none", "softmax"])
def test_gemmini_search_matches_reference(mode, population, tiny_workload):
    got = port_search(tiny_workload, mode, "gemmini", population)
    assert_search_equal(got, _reference(tiny_workload, mode, population))


def test_unported_features_raise(tiny_workload):
    """Population sharding is the one search feature still to port: it
    raises, naming its ROADMAP item.  Device seeding outside the fused
    engine is refused with the reference's ValueError, and portfolio
    requests are fleet requests."""
    from repro_torch.api import SearchRequest
    from repro_torch.core.search import SearchConfig, dosa_search
    from _torch_parity import PORT_SPECS, port_workload
    wl = port_workload(tiny_workload)
    with pytest.raises(NotImplementedError, match="item 7.*sharding"):
        dosa_search(wl, SearchConfig(steps=2, round_every=1,
                                     n_start_points=1, shards=2),
                    population=1, device="cpu")
    for population, fused in ((None, True), (1, False)):
        with pytest.raises(ValueError, match="only the fused engine"):
            dosa_search(wl, SearchConfig(steps=2, round_every=1,
                                         n_start_points=1,
                                         start_points="cosa-device"),
                        population=population, fused=fused, device="cpu")
    assert SearchRequest(workload=wl, specs=(PORT_SPECS["gemmini"],),
                         device="cpu").is_fleet
    with pytest.raises(ValueError):
        SearchConfig(ordering_mode="bogus")
