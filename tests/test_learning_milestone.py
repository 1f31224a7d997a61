"""Learning-milestone regression (BASELINE.md bar), pinned on the RAW
POLICY NETWORK's strength — not the search wrapped around it: a 100-sim
MCTS agent beats random from an UNTRAINED net (step-0 evals in the
committed runs score ~1.00/0.98 non-loss), so MCTS-based asserts are a
low bar.  The milestone asserts that the learned network alone reaches
>=90% non-loss as P0 and >=70% as P1 vs random within the budget, that
the MCTS agent holds >=95% on both seats, and that the loss halves.

Recipe: the reference's best TTT config (ref
Games/Tic_Tac_Toe/models/best_ttt_config: 100 sims, SGD, window 5000,
4x1024 samples/step) run for 2400 steps (configs/training/ttt_long.yaml;
9600 updates) with TWO deliberate changes, both measured:
- RecurrentNet instead of MLP: the reference's MLP applies ReLU after
  the FINAL policy layer (MLP_Network.py:36-39, reproduced in
  networks/mlp.py), so unfamiliar positions emit all-zero "logits" and
  deterministic argmax ties arbitrarily — in a 200-game probe, all 119
  raw-policy P1 losses vs random involved such ties.  The conv policy
  head emits real logits.
- lr 0.05 instead of 0.1: lr 0.1 collapses the quirk head to uniform
  after ~700 steps (policy loss pinned at exactly 1.0 normalized).

Slow (tens of minutes of self-play + training): run with NUZERO_SLOW=1:
    NUZERO_SLOW=1 python -m pytest tests/test_learning_milestone.py -q
The committed run artifact runs/ttt_long_r3/ (journal + plots) is the
standing evidence; this test reproduces it end-to-end.
"""

import os

import pytest

pytestmark = pytest.mark.skipif(
    not os.environ.get("NUZERO_SLOW"),
    reason="slow learning run; set NUZERO_SLOW=1 to enable",
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_milestones(records):
    """Shared asserts, applied to a freshly-run or committed journal."""
    # Raw-policy network strength (the real milestone).
    pol_hits = [
        r
        for r in records
        if r.get("nonloss/policy_as_p0", 0) >= 0.90
        and r.get("nonloss/policy_as_p1", 0) >= 0.70
    ]
    assert pol_hits, (
        "raw policy never reached 90%/70% non-loss (P0/P1) vs random"
    )
    # Search-backed agent comfortably above the BASELINE bar on both seats.
    mcts_hits = [
        r
        for r in records
        if r.get("nonloss/mcts_as_p0", 0) >= 0.95
        and r.get("nonloss/mcts_as_p1", 0) >= 0.95
    ]
    assert mcts_hits, "MCTS agent never reached 95% non-loss on both seats"
    # And the optimization itself worked: policy loss halves.
    losses = [r["loss/policy"] for r in records if "loss/policy" in r]
    assert losses[-1] < 0.5 * losses[0]


def test_committed_run_meets_milestones():
    """The committed artifact itself must satisfy the milestone — guards
    against README/commit overclaim drift."""
    import json

    path = os.path.join(REPO, "runs", "ttt_long_r3c", "journal.jsonl")
    if not os.path.exists(path):
        pytest.skip("no committed ttt_long_r3c artifact")
    with open(path) as f:
        records = [json.loads(line) for line in f]
    _assert_milestones(records)


def test_ttt_policy_network_learns(tmp_path):
    from nuzero.config import load_search_config, load_training_config
    from nuzero.envs import TicTacToe
    from nuzero.networks import NetworkManager, RecurrentNet
    from nuzero.training import AlphaZero

    cfg = load_training_config(
        os.path.join(REPO, "configs", "training", "ttt_long.yaml")
    )
    search = load_search_config(
        os.path.join(REPO, "configs", "search", "ttt_search.yaml")
    )
    env = TicTacToe()
    net = RecurrentNet(
        policy_channels=env.action_space_shape[0],
        num_filters=64,
        num_blocks=2,
        hex=False,
    )
    mgr = NetworkManager(net, env.observation_shape)
    az = AlphaZero(env, mgr, cfg, search, run_dir=str(tmp_path))
    az.run(seed=0)
    _assert_milestones(az.journal.load())
