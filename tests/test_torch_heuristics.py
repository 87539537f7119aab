"""Port parity for the experiment-design heuristics (CPU).

- ExpSparse: t_k equal to the JAX core's in f32.
- PGH: the particle indices are injected on both sides (the port's
  ``draw_indices`` hook; the JAX core's ``jax.random.categorical``
  replaced for the call), so t and the inversion field must be equal,
  including the collision redraw and the ε floor.
- ``keyed_tiebreak_argmax``: non-tied scores give the plain argmax; exact
  ties are broken uniformly (χ² over 4000 draws).
- EIG and risk greedy cores pick the JAX core's candidate on a bank
  carried across with ``state_from_numpy``; on a trial-batched bank each
  trial picks what it picks alone.
- The stateful ``__call__`` draws from the updater's generator;
  ``from_reference`` carries ExpSparse and PGH.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qinfer_tpu as qi
import qinfer_tpu_torch as qt
from qinfer_tpu.smc import init_smc_state
from qinfer_tpu_torch.heuristics import keyed_tiebreak_argmax
from qinfer_tpu_torch.interop import from_reference, state_from_numpy

torch.set_num_threads(2)


def _states(n, seed, d=1, locs=None):
    """(JAX state, port state) of one bank: a uniform prior's cloud, or
    ``locs``, with random normalized weights."""
    st = init_smc_state(jax.random.PRNGKey(seed), qi.SimplePrecessionModel(),
                        n, qi.UniformDistribution([[0.0, 1.0]] * d))
    rng = np.random.default_rng(seed)
    lw = np.log(rng.random(n))
    lw = (lw - np.log(np.exp(lw).sum())).astype(np.float32)
    st = st._replace(particle_log_weights=jnp.asarray(lw))
    if locs is not None:
        st = st._replace(particle_locations=jnp.asarray(locs, jnp.float32))
    return st, state_from_numpy(jax.tree_util.tree_map(np.asarray, st))


@pytest.mark.parametrize("scale,base", [(1.0, 9 / 8), (2.0, 2.0),
                                        (0.37, 1.3)])
def test_exp_sparse_times_equal_jax(scale, base):
    st_j, st_t = _states(16, 0)
    core_j = qi.ExpSparseHeuristic(None, scale=scale, base=base).core
    core_t = qt.ExpSparseHeuristic(None, scale=scale, base=base).core
    for k in range(60):
        t_j = np.asarray(core_j.propose(None, st_j, jnp.asarray(k))["t"])
        t_t = core_t.propose(None, st_t, k)["t"].numpy()
        assert t_t.dtype == np.float32 and t_t.shape == (1,)
        np.testing.assert_array_equal(t_t, t_j)


def _jax_pgh(monkeypatch, core, state, draws):
    """The JAX core's proposal with ``jax.random.categorical`` returning
    the given index pairs in turn (the first draw, then the redraw that
    the while loop traces once)."""
    pairs = iter(list(draws) + [draws[-1]])
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits, shape: jnp.asarray(next(pairs)))
    return core.propose(jax.random.PRNGKey(0), state, jnp.asarray(0))


def _inject(*pairs):
    """A draw_indices hook handing out these pairs, the last repeated."""
    def draw(generator, log_w, n_draws):
        flat = list(pairs) + [pairs[-1]] * (n_draws // 2 - len(pairs))
        return torch.tensor([sum(flat, [])] * log_w.shape[0])
    return draw


@pytest.mark.parametrize("pair", [[3, 17], [40, 2], [0, 63]])
def test_pgh_with_injected_indices_equals_jax(monkeypatch, pair):
    st_j, st_t = _states(64, 1, d=2)
    core_j = qi.PGH(None, inv_field="w_").core
    ep_j = _jax_pgh(monkeypatch, core_j, st_j, [pair])
    core_t = qt.PGH(None, inv_field="w_", draw_indices=_inject(pair)).core
    ep_t = core_t.propose(None, st_t, 0)
    assert ep_t["t"].shape == (1,) and ep_t["w_"].shape == (1, 2)
    np.testing.assert_array_equal(ep_t["t"].numpy(), np.asarray(ep_j["t"]))
    np.testing.assert_array_equal(ep_t["w_"].numpy(), np.asarray(ep_j["w_"]))


def test_pgh_collision_redraws_like_jax(monkeypatch):
    """A first pair that collides is redrawn; both take the redraw."""
    locs = np.linspace(0, 1, 64, dtype=np.float32)[:, None]
    locs[5] = locs[9]
    st_j, st_t = _states(64, 2, locs=locs)
    ep_j = _jax_pgh(monkeypatch, qi.PGH(None).core, st_j, [[5, 9], [1, 30]])
    ep_t = qt.PGH(None, draw_indices=_inject([5, 9], [1, 30])).core.propose(
        None, st_t, 0)
    np.testing.assert_array_equal(ep_t["t"].numpy(), np.asarray(ep_j["t"]))
    assert float(ep_t["t"][0]) == pytest.approx(1 / abs(locs[1, 0]
                                                        - locs[30, 0]))


def test_pgh_all_collisions_hit_the_floor():
    """A collapsed cloud exhausts the redraws: t = 1/ε, as the JAX core
    gives (tests/test_round4_fixes.py)."""
    locs = np.full((64, 1), 0.5, np.float32)
    st_j, st_t = _states(64, 0, locs=locs)
    core_j = qi.PGH(None).core
    t_j = float(jax.jit(core_j.propose)(jax.random.PRNGKey(1), st_j,
                                        jnp.int32(0))["t"][0])
    t_t = qt.PGH(None).core.propose(torch.Generator().manual_seed(0), st_t,
                                    0)["t"]
    assert float(t_t[0]) == t_j == np.float32(1.0 / core_j.eps_dist)


def test_pgh_on_a_trial_batch_is_per_trial():
    """On (T, N, D) banks each trial proposes from its own bank, as a
    single-bank call on that trial with the same indices."""
    rng = np.random.default_rng(3)
    locs = torch.from_numpy(rng.random((4, 50, 2)).astype(np.float32))
    g = torch.Generator().manual_seed(0)
    batch = qt.init_batched_smc_state(g, qt.MultiCosModel(2), 4, 50,
                                      qt.UniformDistribution([[0, 1]] * 2))
    batch = dataclasses.replace(batch, particle_locations=locs)
    core = qt.PGH(None, inv_field="w_", draw_indices=_inject([7, 11])).core
    ep = core.propose(g, batch, 0)
    assert ep["t"].shape == (4,) and ep["w_"].shape == (4, 2)
    for i in range(4):
        one = dataclasses.replace(
            batch, particle_locations=locs[i],
            particle_log_weights=batch.particle_log_weights[i])
        ep_i = core.propose(g, one, 0)
        assert torch.equal(ep_i["t"], ep["t"][i:i + 1])
        assert torch.equal(ep_i["w_"], ep["w_"][i:i + 1])


def test_pgh_draws_follow_the_weights():
    """The default draw is categorical by weight: a bank with all weight
    on two particles proposes only their distance."""
    locs = np.linspace(0, 1, 100, dtype=np.float32)[:, None]
    _, st = _states(100, 0, locs=locs)
    lw = torch.full((100,), -1e30)
    lw[10], lw[60] = np.log(0.5), np.log(0.5)
    st = dataclasses.replace(st, particle_log_weights=lw)
    g = torch.Generator().manual_seed(4)
    core = qt.PGH(None).core
    ts = {round(float(core.propose(g, st, 0)["t"][0]), 3) for _ in range(40)}
    assert ts == {round(float(1 / (locs[60, 0] - locs[10, 0])), 3)}


def test_tiebreak_leaves_distinct_scores_exact():
    g = torch.Generator().manual_seed(0)
    score = torch.tensor([[0.1, 0.7, 0.3], [2.0, -1.0, 1.999]])
    assert keyed_tiebreak_argmax(g, score).tolist() == [1, 0]
    assert int(keyed_tiebreak_argmax(g, score[0])) == 1


def test_tiebreak_is_uniform_over_ties():
    """Ties at candidates 1, 2 and 4 of five: 4000 draws, χ² with two
    degrees of freedom below 13.8 (p = 0.001), and never a non-tied one."""
    g = torch.Generator().manual_seed(1)
    score = torch.tensor([1.0, 3.0, 3.0, 0.0, 3.0]).expand(4000, 5)
    picks = keyed_tiebreak_argmax(g, score).numpy()
    counts = np.bincount(picks, minlength=5)
    assert counts[0] == counts[3] == 0
    expected = 4000 / 3
    chi2 = sum((counts[k] - expected) ** 2 / expected for k in (1, 2, 4))
    assert chi2 < 13.8, counts


@pytest.mark.parametrize("use_eig", [True, False], ids=["eig", "risk"])
def test_greedy_core_picks_the_jax_candidate(use_eig):
    """The same carried bank and candidate times: the same pick."""
    st_j, st_t = _states(2048, 5)
    cands = {"t": np.array([0.5, 1.7, 3.1, 6.0, 11.0], np.float32)}
    heur_j = qi.EIGHeuristic if use_eig else qi.RiskHeuristic
    heur_t = qt.EIGHeuristic if use_eig else qt.RiskHeuristic
    ep_j = heur_j(None, model=qi.SimplePrecessionModel(),
                  candidates=cands).core.propose(jax.random.PRNGKey(0), st_j,
                                                 jnp.asarray(0))
    ep_t = heur_t(None, model=qt.SimplePrecessionModel(),
                  candidates=cands).core.propose(
        torch.Generator().manual_seed(0), st_t, 0)
    assert ep_t["t"].shape == (1,)
    np.testing.assert_array_equal(ep_t["t"].numpy(),
                                  np.asarray(ep_j["t"]).reshape(-1))


def test_greedy_core_on_a_trial_batch_is_per_trial():
    g = torch.Generator().manual_seed(2)
    model = qt.SimplePrecessionModel()
    batch = qt.init_batched_smc_state(g, model, 3, 512,
                                      qt.UniformDistribution([0, 1]))
    batch, _ = qt.smc_update_step_batched(
        model, qt.LiuWestResampler(), qt.SMCConfig(resample_thresh=-1.0),
        batch, torch.tensor([0, 1, 1]), {"t": torch.tensor([2.0, 5.0, 9.0])})
    core = qt.EIGHeuristic(None, model=model, candidates={
        "t": np.linspace(0.5, 12.0, 9)}).core
    ep = core.propose(g, batch, 0)
    assert ep["t"].shape == (3,)
    for i in range(3):
        one = dataclasses.replace(
            batch, particle_locations=batch.particle_locations[i],
            particle_log_weights=batch.particle_log_weights[i])
        assert torch.equal(core.propose(g, one, 0)["t"], ep["t"][i:i + 1])


def test_stateful_heuristics_draw_from_the_updater():
    u = qt.SMCUpdater(qt.SimplePrecessionModel(), 300,
                      qt.UniformDistribution([0.0, 1.0]), seed=0,
                      device="cpu")
    h = qt.ExpSparseHeuristic(u, scale=2.0, base=2.0)
    ep0, ep1 = h(), h()
    assert float(ep1["t"][0]) == 2 * float(ep0["t"][0])
    before = u.state.generator.get_state()
    ep = qt.PGH(u, other_fields={"n_meas": 5})()
    assert float(ep["t"][0]) > 0 and ep["n_meas"].tolist() == [5.0]
    assert not torch.equal(before, u.state.generator.get_state())


def test_interop_heuristics():
    sparse = from_reference(qi.ExpSparseHeuristic(None, scale=3.0, base=1.5,
                                                   t_field="tau"))
    assert isinstance(sparse, qt.ExpSparseHeuristic)
    assert (sparse.core.scale, sparse.core.base, sparse.core.t_field) == (
        3.0, 1.5, "tau")
    pgh = from_reference(qi.PGH(None, inv_field="w_", maxiters=4,
                                other_fields={"n_meas": 10}))
    assert isinstance(pgh, qt.PGH)
    assert (pgh.core.inv_field, pgh.core.maxiters, pgh.core.other_fields) == (
        "w_", 4, (("n_meas", 10),))
    with pytest.raises(ValueError, match="t_func"):
        from_reference(qi.PGH(None, t_func=lambda t: 2 * t))
