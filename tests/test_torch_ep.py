"""The port's expert-parallel train steps and the MoE's routing over the
reference's token set (``models/moe.py`` on ``parallel/overlap.py``'s
collectives) in gloo worlds on the CPU, against the JAX package's
one-device step on the same global batch: ``tests/test_torch_tp.py``'s
worlds, checks and tolerances, on the tiny MoE Llama (4 experts, top 2,
capacity factor 0.5, so tokens drop) and, on the expert axis, the dense
Llama (whose leaves the rules do not cut over it: its expert ranks are
copies).

Meshes: ``expert=2`` (``grad_accum`` 1 and 2), ``tensor=2``, ``tensor=2 x
expert=2`` (a world of 4), ``fsdp=2 x tensor=2``, ``data=2 x tensor=2``,
and ``data=2`` at ``grad_accum=1``: the reference's GSPMD step routes the
global batch's tokens there (capacity from the global count, queue
positions over the whole batch), which the port routes the same way by
exchanging per-expert counts over the batch group (ROADMAP Queue 3).
"""

import pytest

from tests.test_torch_tp import (  # noqa: F401
    _name,
    _process_state_unchanged,
    check_against_jax,
    check_ranks,
    check_records,
    run_worlds,
)

MESHES = {"tensor2": {"tensor": 2}, "expert2": {"expert": 2},
          "data2": {"data": 2},
          "tensor2xexpert2": {"tensor": 2, "expert": 2},
          "fsdp2xtensor2": {"fsdp": 2, "tensor": 2},
          "data2xtensor2": {"data": 2, "tensor": 2}}
CASES = [("tensor2", "moe", 512, 1),
         ("expert2", "moe", 512, 1), ("expert2", "moe", 512, 2),
         ("data2", "moe", 512, 1),
         ("tensor2xexpert2", "moe", 512, 1),
         ("tensor2xexpert2", "llama", 512, 1),
         ("fsdp2xtensor2", "moe", 512, 1),
         ("data2xtensor2", "moe", 512, 1)]
IDS = [_name(*c) for c in CASES]


@pytest.fixture(scope="module")
def ep_steps(tmp_path_factory):
    return run_worlds(tmp_path_factory.mktemp("ep"), MESHES, CASES)


@pytest.mark.parametrize("mesh,fam,vocab,k", CASES, ids=IDS)
def test_ep_step_matches_the_jax_one_device_step(ep_steps, mesh, fam, vocab,
                                                 k):
    check_against_jax(ep_steps, mesh, fam, vocab, k)


@pytest.mark.parametrize("mesh,fam,vocab,k", CASES, ids=IDS)
def test_ep_ranks_hold_one_tree_and_their_slices(ep_steps, mesh, fam, vocab,
                                                 k):
    check_ranks(ep_steps, mesh, fam, vocab, k)


@pytest.mark.parametrize("mesh,fam,vocab,k", CASES, ids=IDS)
def test_ep_grad_norm_and_health_match_one_rank(ep_steps, mesh, fam, vocab,
                                                k):
    check_records(ep_steps, mesh, fam, vocab, k)
