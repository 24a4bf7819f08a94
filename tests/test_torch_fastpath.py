"""PyTorch port: augmentation chains and the batched fast path, on the CPU.

Torch cannot reproduce JAX's keys, so the port separates drawing from
applying: ``chain.draw(gen, n)`` makes a plan, ``chain.apply(plan, x)`` and
``fastpath.eval_manipulators_batched`` evaluate it. Here:

- small chains (a 2-stage shuffle, a parallel reverb, gated stages, a
  3-stage shuffle, divergent groups) against JAX: :func:`jax_plan` replays
  the key tree that JAX's ``AugmentationChain.__call__`` walks into a plan,
  and the port's ``apply`` of it is held to JAX's output for the same keys,
  1e-4 of max|jax|;
- the port's fast path against its generic walk under one plan, for the 4
  default instrument chains: 2e-5 of max|generic| (the log-depth complex
  scans round differently with the batch's shape);
- dynamic ``probs`` against chains rebuilt with those probabilities, and
  the entry point's shape guard.

The JAX oracles are single chains of 1-3 stages: JAX's 4-instrument
augmentation program takes minutes to compile on the CPU.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_mixing_style_transfer_tpu.fx import factory as jfactory
from music_mixing_style_transfer_tpu_torch.fx import factory as pfactory
from music_mixing_style_transfer_tpu_torch.fx.chain import AugmentationChain, Stage, cat_plans
from music_mixing_style_transfer_tpu_torch.fx.fastpath import (
    UnsupportedTopology,
    eval_grouped,
    eval_manipulators_batched,
)
from music_mixing_style_transfer_tpu_torch.train.fused import augment_contrastive_views

torch.set_num_threads(2)
INSTS = ("drums", "bass", "other", "vocals")


def rel_close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * scale, f"max err {err} > {rel} x {scale}"


def _replay(chain, key, probs=None):
    """One draw's plan from one JAX key, walking the key tree of JAX's
    ``AugmentationChain.__call__`` / ``_apply_stage``."""
    n = len(chain.stages)
    k_perm, k_par, *stage_keys = jax.random.split(key, n + 2)
    plan = {}
    if chain.shuffle and n > 1:
        plan["perm"] = np.asarray(jax.random.randint(
            k_perm, (), 0, len(list(itertools.permutations(range(n))))))
    if chain.parallel and chain.parallel_weight_factor is None:
        plan["w"] = np.asarray(jax.random.uniform(k_par) / 2.0)
    stages = []
    for stage, sk in zip(chain.stages, stage_keys):
        k_gate, k_param = jax.random.split(sk)
        if stage.is_chain:
            fx = _replay(stage.fx, k_param, probs)
        else:
            fx = {k: np.asarray(v) for k, v in stage.fx.sample(k_param).items()}
        p = None
        if probs is not None and stage.prob_name in probs:
            p = jnp.clip(probs[stage.prob_name] * stage.prob_scale, 0.0, 1.0)
        if p is None and stage.prob >= 1.0:
            gate = np.asarray(True)
        else:
            gate = np.asarray(jax.random.bernoulli(k_gate, stage.prob if p is None else p))
        stages.append({"gate": gate, "fx": fx})
    plan["stages"] = stages
    return plan


def _stack(plans):
    p0 = plans[0]
    if isinstance(p0, dict):
        return {k: _stack([p[k] for p in plans]) for k in p0}
    if isinstance(p0, list):
        return [_stack([p[i] for p in plans]) for i in range(len(p0))]
    a = np.stack(plans)
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu" else a)


def jax_plan(chain, keys, probs=None):
    """The port's plan for JAX's draws ``keys [D, 2]``."""
    return _stack([_replay(chain, k, probs) for k in keys])


def jax_keys(seed, n):
    return jax.random.split(jax.random.PRNGKey(seed), n)


def signals(rng, *shape):
    T = shape[-1]
    env = np.abs(np.sin(np.linspace(0, rng.uniform(3, 12), T)))
    return (rng.standard_normal(shape) * 0.25 * (0.05 + env)).astype(np.float32)


SMALL = [
    ("shuffled_eq_comp", [("eq", 0.9, "eq"), ("comp", 0.9, "comp")], dict(shuffle=True), 1e-4),
    ("parallel_reverb", [("reverb", 0.9, "reverb")], dict(parallel=True), 1e-4),
    ("gated_imager_gain", [("imager", 0.5), ("gain", 0.5), ("pan", 1.0)], {}, 1e-4),
]


@pytest.mark.parametrize("case,names,kw,rel", SMALL, ids=[c[0] for c in SMALL])
def test_small_chains_match_jax_through_a_replayed_plan(rng, case, names, kw, rel):
    jchain = jfactory.create_effects_augmentation_chain(names, **kw)
    pchain = pfactory.create_effects_augmentation_chain(names, **kw)
    keys = jax_keys(7, 4)
    x = signals(rng, 4, 2, 2, 2048)  # [D, items, 2, T]
    want = np.asarray(jax.jit(jax.vmap(lambda k, xi: jchain(k, xi)))(keys, jnp.asarray(x)))
    plan = jax_plan(jchain, keys)
    got = pchain.apply(plan, torch.from_numpy(x)).numpy()
    rel_close(got, want, rel)
    # the fast path consumes the same plan
    fast = eval_grouped([pchain], [4], [plan], torch.from_numpy(x)).numpy()
    rel_close(fast, want, rel)


def test_three_stage_shuffle_falls_back_to_the_generic_walk(rng):
    """A 3-stage shuffle has no batched strategy: ``eval_grouped`` walks the
    generic chain, and both equal JAX under the replayed plan."""
    names = [("gain", 0.9), ("pan", 0.9), ("imager", 0.9)]
    jchain = jfactory.create_effects_augmentation_chain(names, shuffle=True)
    pchain = pfactory.create_effects_augmentation_chain(names, shuffle=True)
    keys = jax_keys(11, 6)
    x = signals(rng, 6, 2, 2, 2048)
    want = np.asarray(jax.jit(jax.vmap(lambda k, xi: jchain(k, xi)))(keys, jnp.asarray(x)))
    plan = jax_plan(jchain, keys)
    assert len(set(plan["perm"].tolist())) > 1
    got = eval_grouped([pchain], [6], [plan], torch.from_numpy(x)).numpy()
    rel_close(got, want, 1e-5)
    np.testing.assert_array_equal(got, pchain.apply(plan, torch.from_numpy(x)).numpy())
    # two groups of one chain take one walk; of two, one walk each
    halves = [_stack([_replay(jchain, k) for k in keys[:3]]), _stack([_replay(jchain, k) for k in keys[3:]])]
    rel_close(eval_grouped([pchain, pchain], [3, 3], halves, torch.from_numpy(x)).numpy(), want, 1e-5)
    other = pfactory.create_effects_augmentation_chain(names, shuffle=True)
    rel_close(eval_grouped([pchain, other], [3, 3], halves, torch.from_numpy(x)).numpy(), want, 1e-5)
    assert issubclass(UnsupportedTopology, Exception)


def test_structurally_divergent_groups_split_and_concat(rng):
    """Adjacent groups with different chain structures evaluate on their own
    draw slices and re-concatenate in draw order, as JAX's."""
    ja = jfactory.create_effects_augmentation_chain([("gain", 0.8)])
    jb = jfactory.create_effects_augmentation_chain([("pan", 0.6), ("imager", 0.9)])
    pa = pfactory.create_effects_augmentation_chain([("gain", 0.8)])
    pb = pfactory.create_effects_augmentation_chain([("pan", 0.6), ("imager", 0.9)])
    keys = jax_keys(13, 6)
    x = signals(rng, 6, 2, 2, 2048)
    got = eval_grouped([pa, pb], [2, 4], [jax_plan(ja, keys[:2]), jax_plan(jb, keys[2:])],
                       torch.from_numpy(x)).numpy()
    want_a = np.asarray(jax.jit(jax.vmap(lambda k, xi: ja(k, xi)))(keys[:2], jnp.asarray(x[:2])))
    want_b = np.asarray(jax.jit(jax.vmap(lambda k, xi: jb(k, xi)))(keys[2:], jnp.asarray(x[2:])))
    rel_close(got[:2], want_a, 1e-5)
    rel_close(got[2:], want_b, 1e-5)


def _default_plans(man, seed, per_inst, probs=None):
    g = torch.Generator().manual_seed(seed)
    return {inst: man[inst].draw(g, per_inst, probs) for inst in INSTS}


@pytest.fixture(scope="module")
def default_case():
    """The 4 default instrument chains, 2 draws each, under one plan:
    (manipulators, plans, x [8, 2, 2, 4096], generic walk's output)."""
    man = pfactory.make_instrument_manipulators()
    plans = _default_plans(man, 3, 2)
    x = torch.from_numpy(signals(np.random.default_rng(4), 8, 2, 2, 4096))
    generic = torch.cat([man[inst].apply(plans[inst], x[2 * i: 2 * i + 2])
                         for i, inst in enumerate(INSTS)])
    return man, plans, x, generic


def test_fast_path_equals_the_generic_walk_under_one_plan(default_case):
    man, plans, x, generic = default_case
    # the drums' dual-band reverb splits the draws; every stage gated both ways somewhere
    gates = torch.cat([cat_plans([plans[i]])["stages"][0]["gate"] for i in INSTS])
    assert gates.any()
    fast = eval_manipulators_batched(man, INSTS, plans, x, 2)
    assert torch.isfinite(fast).all() and fast.shape == x.shape
    rel_close(fast.numpy(), generic.numpy(), 2e-5)


def test_augmented_views_fast_equals_generic(default_case):
    """``augment_contrastive_views``: int16 segments, one draw per (item,
    k) on both contents, pad trimmed and clipped; fast and generic walks."""
    man, _, _, _ = default_case
    rng = np.random.default_rng(9)
    segs = torch.from_numpy((signals(rng, 4, 1, 2, 2, 4096) * 32768).astype(np.int16))
    plans = _default_plans(man, 5, 2)  # 1 item x K = 2
    a1, b1 = augment_contrastive_views(man, INSTS, segs, plans, pad=512, fast=False)
    a2, b2 = augment_contrastive_views(man, INSTS, segs, plans, pad=512, fast=True)
    assert a1.shape == (4, 2, 2, 4096 - 1024) and b1.shape == a1.shape
    assert float(a1.abs().max()) <= 1.0
    rel_close(a2.numpy(), a1.numpy(), 2e-5)
    rel_close(b2.numpy(), b1.numpy(), 2e-5)


def test_dynamic_probs_equal_rebuilt_chains():
    """Gates drawn with ``probs`` equal gates of chains rebuilt with those
    probabilities: one uniform per gate whatever the probability."""
    probs = {"eq": 0.3, "comp": 1.0, "pan": 0.0, "imager": 0.55, "gain": 0.25}
    base = pfactory.make_instrument_manipulators()
    rebuilt = pfactory.make_instrument_manipulators(apply_prob_dict=probs)
    got, want = _default_plans(base, 8, 5, probs), _default_plans(rebuilt, 8, 5)

    def leaves(p):
        if isinstance(p, dict):
            return [t for k in sorted(p) for t in leaves(p[k])]
        if isinstance(p, list):
            return [t for v in p for t in leaves(v)]
        return [p]

    lg, lw = leaves(got), leaves(want)
    assert len(lg) == len(lw)
    for a, b in zip(lg, lw):
        assert torch.equal(a, b)
    assert not got["bass"]["stages"][1]["fx"]["stages"][0]["gate"].any()  # pan at 0


def test_entry_point_shape_guard():
    man = pfactory.make_instrument_manipulators()
    with pytest.raises(ValueError, match="draw batch"):
        eval_manipulators_batched(man, INSTS, _default_plans(man, 1, 2), torch.zeros(5, 2, 2, 256), 2)


def test_chain_rejects_long_shuffles():
    with pytest.raises(ValueError, match="shuffle"):
        AugmentationChain([Stage(None)] * 4, shuffle=True)
