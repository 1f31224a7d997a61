"""Headless pygame viewer tests (SDL dummy driver).

Parity target: ``Games/SCS/SCS_Renderer.py`` board drawing + counter
creation; the reference has no renderer tests at all.
"""

import os

import numpy as np
import pytest

pygame = pytest.importorskip("pygame")

os.environ.setdefault("SDL_VIDEODRIVER", "dummy")

from nuzero.envs.scs import SCSGame, make_scenario
from nuzero.utils.viewer import SCSViewer, create_counter


@pytest.fixture(scope="module")
def game():
    return SCSGame(make_scenario("randomized", 5, seed=5))


def _play(game, n, seed=0):
    import jax

    step = jax.jit(game.step)
    rng = np.random.default_rng(seed)
    state = game.init(None)
    for _ in range(n):
        if bool(game.terminal(state)):
            break
        acts = np.flatnonzero(np.asarray(game.legal_mask(state)))
        state = step(state, int(rng.choice(acts)))
    return state


def test_frame_renders_board(game):
    viewer = SCSViewer(game)
    surf = viewer.frame(_play(game, 12))
    assert surf.get_size() == viewer.size
    px = pygame.surfarray.array3d(surf)
    # Not a blank canvas: terrain, grid, and counters produce many colors.
    colors = np.unique(px.reshape(-1, 3), axis=0)
    assert len(colors) > 10


def test_save_png(tmp_path, game):
    viewer = SCSViewer(game)
    p = viewer.save_png(game.init(None), str(tmp_path / "board.png"))
    assert os.path.getsize(p) > 1000


def test_create_counter(tmp_path):
    p = create_counter(str(tmp_path / "c.png"), 2, 2, 4, player=1)
    assert os.path.getsize(p) > 500


def test_replay_states_match_engine(game):
    import jax

    step = jax.jit(game.step)
    viewer = SCSViewer(game)
    rng = np.random.default_rng(1)
    state = game.init(None)
    actions = []
    for _ in range(6):
        acts = np.flatnonzero(np.asarray(game.legal_mask(state)))
        a = int(rng.choice(acts))
        actions.append(a)
        state = step(state, a)
    states = viewer._replay_states(actions)
    assert len(states) == 7
    np.testing.assert_array_equal(np.asarray(states[-1].board), np.asarray(state.board))


def test_analyse_run_cli_headless(tmp_path, monkeypatch):
    """run.py --analyse end-to-end under the dummy SDL driver: plays a game
    with the run's checkpoint, saves the history, auto-replays it."""
    import jax

    import run as runner
    from nuzero.config.run_meta import save_run_meta
    from nuzero.utils.checkpoint import save_checkpoint

    monkeypatch.setattr(runner, "RUNS", str(tmp_path))
    run_dir = tmp_path / "scs_tiny"
    run_dir.mkdir()
    env = runner._scs_env("solo_scout_5.yml")
    manager = runner._managers(env, "recurrent")
    params = manager.init(jax.random.key(0))
    save_checkpoint(str(run_dir / "checkpoints"), 1, {"params": params})
    save_run_meta(str(run_dir), "scs", "recurrent",
                  scenario="solo_scout_5.yml")

    actions = runner.analyse_run("scs_tiny", max_moves=10, auto=True, fps=1000)
    assert 1 <= len(actions) <= 10
    assert (run_dir / "analysis_actions.json").exists()
