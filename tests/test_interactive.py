"""Interactive wizard: config-building flow round-trips through the real
loaders (ref Interactive.py new_training, which the reference README marks
broken — here it must actually work)."""

import io

from nuzero.interactive import Wizard


def _scripted(answers):
    it = iter(answers)

    def input_fn(prompt):
        return next(it)

    return input_fn


def test_new_training_writes_loadable_configs(tmp_path, monkeypatch):
    import nuzero.interactive as interactive

    monkeypatch.setattr(interactive, "REPO", str(tmp_path))
    out = io.StringIO()
    # game=ttt, arch=mlp, name, then all-default hyperparameters
    # (empty string = accept default), optimizer=SGD, mode=sequential.
    answers = ["0", "0", "wiz_test"] + [""] * 7 + ["0", ""] + [""] * 4 + ["0"]
    w = Wizard(_scripted(answers), out.write)
    game, arch, name, train_path, search_path = w.new_training(launch=False)
    assert (game, arch, name) == ("ttt", "mlp", "wiz_test")

    from nuzero.config import load_search_config, load_training_config

    cfg = load_training_config(train_path)
    assert cfg.network_name == "wiz_test"
    assert cfg.running.training_steps == 300
    assert cfg.optimizer.optimizer_choice == "SGD"
    assert cfg.optimizer.starting_lr == 0.1
    assert cfg.learning.normalize_cel is True
    search = load_search_config(search_path)
    assert search.num_simulations == 100
    assert search.keep_subtree is True


def test_printbar_output():
    from nuzero.utils.printbar import PrintBar

    out = io.StringIO()
    bar = PrintBar("fill", total=4, width=4, stream=out)
    for _ in range(4):
        bar.next()
    lines = [l for l in out.getvalue().splitlines() if l]
    assert lines[0].startswith("fill |····|")
    assert lines[-1].endswith("100%")
    assert "████" in lines[-1]


def test_continue_flow_resumes_end_to_end(tmp_path, monkeypatch):
    """The wizard continue flow actually loads the checkpoint and resumes
    training (ref Interactive.py:126-173) — no printed instructions."""
    import nuzero.interactive as interactive

    monkeypatch.setattr(interactive, "REPO", str(tmp_path))

    import jax

    from nuzero.config import load_training_config
    from nuzero.config.run_meta import save_run_meta
    from nuzero.config.yaml_io import save_yaml
    from nuzero.envs import TicTacToe
    from nuzero.networks import MLPNetwork, NetworkManager
    from nuzero.search import SearchParams
    from nuzero.training import AlphaZero

    run_dir = tmp_path / "runs" / "tiny"
    run_dir.mkdir(parents=True)
    save_yaml(
        {
            "Initialization": {"network_name": "tiny"},
            "Running": {
                "num_actors": 8,
                "early_fill_per_type": 8,
                "training_steps": 2,
                "Sequential": {"num_games_per_type_per_step": 2},
            },
            "Learning": {
                "replay_window_size": 64,
                "Samples": {"batch_size": 8, "num_samples": 1},
            },
            "Saving": {"save_frequency": 1},
            "Scheduler": {"starting_lr": 1e-3},
        },
        str(run_dir / "train_config.yaml"),
    )
    save_yaml(
        {"Simulation": {"mcts_simulations": 4}},
        str(run_dir / "search_config.yaml"),
    )
    save_run_meta(str(run_dir), "ttt", "mlp", hex=False)

    env = TicTacToe()
    mgr = NetworkManager(MLPNetwork(out_features=9), env.observation_shape)
    cfg = load_training_config(str(run_dir / "train_config.yaml"))
    az = AlphaZero(
        env, mgr, cfg, SearchParams(num_simulations=4), run_dir=str(run_dir)
    )
    az.run(seed=0)
    steps_before = [r["step"] for r in az.journal.load() if "step" in r]
    assert max(steps_before) == 2

    out = []
    # choice 0 = the only run; extra steps = 2.
    w = interactive.Wizard(_scripted(["0", "2"]), out.append)
    name = w.continue_()
    assert name == "tiny"
    assert any("resuming tiny from step 2" in s for s in out)
    recs = az.journal.load()
    steps = [r["step"] for r in recs if "step" in r]
    assert max(steps) == 4, "resume should have trained steps 3 and 4"
