"""Config schemas: Training / Search (Testing lives in evaluation/).

Mirrors the reference's three YAML schemas (ref
``Configs/Training/Examples/documentation_training_config.yaml``,
``Configs/Search/Examples/documentation_search_config.yaml``) as frozen
dataclasses.  Defaults equal the documented defaults.  Loaders accept the
reference's exact YAML section/key layout so existing configs port over
unchanged.

Reference knobs that are artifacts of the Ray runtime keep their meaning
re-mapped to the batched engine (documented per-field):
- ``num_actors`` -> self-play batch size (lockstep games on device).
- ``batch_extraction``/``shared_storage_size`` -> obsolete (the buffer and
  params are device-resident); accepted and ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from nuzero.config.yaml_io import load_yaml
from nuzero.search.mcts import SearchParams


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    cp_network_name: str = ""
    iteration_number: str | int = "auto"
    keep_optimizer: bool = True
    keep_scheduler: bool = False
    load_buffer: bool = True
    fresh_start: bool = False
    new_plots: bool = False


@dataclasses.dataclass(frozen=True)
class RunningConfig:
    running_mode: str = "sequential"  # sequential | asynchronous
    num_actors: int = 128  # lockstep self-play batch size
    early_fill_per_type: int = 0
    early_softmax_moves: int = 0
    early_softmax_exploration: float = 0.8
    early_random_exploration: float = 0.5
    training_steps: int = 100
    num_games_per_type_per_step: int = 12  # sequential mode
    update_delay: float = 0.0  # asynchronous mode (seconds)
    max_trajectory_length: int = 0  # 0 = env.max_game_length (memory knob)


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Self-play inference cache (ref training-YAML ``Cache`` section).

    Obsolete by design on this runtime: the reference's caches memoize
    batch-1 host inference inside Gamer/Explorer (``Explorer.py:137-160``),
    which the fully-batched on-device MCTS eliminated.  The section is
    accepted (configs port unchanged) and the coordinator prints a notice
    when enabled.  Caches DO serve the host-driven surfaces: per-agent
    ``Cache`` sections in Testing YAMLs and ``run.py --play --cache``.
    """

    cache_choice: str = "disabled"  # dict | keyless | disabled
    max_size: int = 12000
    # The reference's ``keep_updated`` knob (refresh cached inferences on
    # weight updates) is accepted in YAML and ignored: training-loop caches
    # are obsolete here (see class docstring).


@dataclasses.dataclass(frozen=True)
class SavingConfig:
    """Ref ``Saving`` section.  ``storage_frequency`` (how often weights
    ship to the Ray shared storage, ref ``AlphaZero.py:291-294``) is
    accepted in YAML and ignored: params are device-resident and actors
    read them directly every move-batch."""

    save_frequency: int = 20
    save_buffer: bool = True


@dataclasses.dataclass(frozen=True)
class TestingFrequencyConfig:
    asynchronous_testing: bool = False
    testing_actors: int = 32  # evaluation batch size
    early_testing: bool = False
    policy_test_frequency: int = 25
    mcts_test_frequency: int = 65
    num_policy_test_games: int = 100
    num_mcts_test_games: int = 100
    test_game_index: int = 0
    # Extension over the reference (whose in-loop tests are vs random only,
    # AlphaZero.py:596-645): also evaluate against the scripted GoalRush
    # baseline each test step — the meaningful strength yardstick on
    # contested SCS maps.  Journals wr/*_vs_gr_* series.  SCS-only.
    goal_rush_opponent: bool = False


@dataclasses.dataclass(frozen=True)
class PlottingConfig:
    plot_loss: bool = True
    plot_weights: bool = False
    plot_frequency: int = 10
    recent_steps_loss: int = 200


@dataclasses.dataclass(frozen=True)
class RecurrentOptions:
    train_iterations: Tuple[int, ...] = (2,)
    pred_iterations: Tuple[int, ...] = (2,)
    test_iterations: int = 2
    alpha: float = 0.0


@dataclasses.dataclass(frozen=True)
class LearningConfig:
    replay_window_size: int = 5000  # games (not positions)
    value_loss: str = "SE"  # SE | AE
    policy_loss: str = "CEL"  # CEL | KLD
    normalize_cel: bool = False
    learning_method: str = "samples"  # samples | epochs
    # Samples
    batch_size: int = 256
    num_samples: int = 32
    with_replacement: bool = True
    late_heavy: bool = False
    # Epochs
    epochs_batch_size: int = 2048
    learning_epochs: int = 1
    plot_epochs: bool = False


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    optimizer_choice: str = "Adam"  # Adam | SGD
    weight_decay: float = 1.0e-7
    momentum: float = 0.9
    nesterov: bool = False
    starting_lr: float = 5.0e-5
    scheduler_boundaries: Tuple[int, ...] = ()
    scheduler_gamma: float = 0.5


@dataclasses.dataclass(frozen=True)
class TrainingConfig:
    network_name: str = "net"
    load_checkpoint: bool = False
    checkpoint: CheckpointConfig = CheckpointConfig()
    running: RunningConfig = RunningConfig()
    cache: CacheConfig = CacheConfig()
    saving: SavingConfig = SavingConfig()
    testing: TestingFrequencyConfig = TestingFrequencyConfig()
    plotting: PlottingConfig = PlottingConfig()
    recurrent: RecurrentOptions = RecurrentOptions()
    learning: LearningConfig = LearningConfig()
    optimizer: OptimizerConfig = OptimizerConfig()


def _get(d, *path, default=None):
    node = d
    for p in path:
        if node is None or p not in node:
            return default
        node = node[p]
    return node


def training_config_from_dict(d: dict) -> TrainingConfig:
    """Parse the reference training-YAML layout
    (ref ``documentation_training_config.yaml``)."""

    def g(*path, default=None):
        return _get(d, *path, default=default)

    defaults = TrainingConfig()

    def section(cls, mapping):
        kwargs = {}
        for field, value in mapping.items():
            if value is not None:
                kwargs[field] = value
        return cls(**kwargs)

    checkpoint = section(
        CheckpointConfig,
        dict(
            cp_network_name=g("Initialization", "Checkpoint", "cp_network_name"),
            iteration_number=g("Initialization", "Checkpoint", "iteration_number"),
            keep_optimizer=g("Initialization", "Checkpoint", "keep_optimizer"),
            keep_scheduler=g("Initialization", "Checkpoint", "keep_scheduler"),
            load_buffer=g("Initialization", "Checkpoint", "load_buffer"),
            fresh_start=g("Initialization", "Checkpoint", "fresh_start"),
            new_plots=g("Initialization", "Checkpoint", "new_plots"),
        ),
    )
    running = section(
        RunningConfig,
        dict(
            running_mode=g("Running", "running_mode"),
            num_actors=g("Running", "num_actors"),
            early_fill_per_type=g("Running", "early_fill_per_type"),
            early_softmax_moves=g("Running", "early_softmax_moves"),
            early_softmax_exploration=g("Running", "early_softmax_exploration"),
            early_random_exploration=g("Running", "early_random_exploration"),
            training_steps=g("Running", "training_steps"),
            num_games_per_type_per_step=g(
                "Running", "Sequential", "num_games_per_type_per_step"
            ),
            update_delay=g("Running", "Asynchronous", "update_delay"),
            max_trajectory_length=g("Running", "max_trajectory_length"),
        ),
    )
    cache = section(
        CacheConfig,
        dict(
            cache_choice=g("Cache", "cache_choice"),
            max_size=g("Cache", "max_size"),
        ),
    )
    saving = section(
        SavingConfig,
        dict(
            save_frequency=g("Saving", "save_frequency"),
            save_buffer=g("Saving", "save_buffer"),
        ),
    )
    testing = section(
        TestingFrequencyConfig,
        dict(
            asynchronous_testing=g("Testing", "asynchronous_testing"),
            testing_actors=g("Testing", "testing_actors"),
            early_testing=g("Testing", "early_testing"),
            policy_test_frequency=g("Testing", "policy_test_frequency"),
            mcts_test_frequency=g("Testing", "mcts_test_frequency"),
            num_policy_test_games=g("Testing", "num_policy_test_games"),
            num_mcts_test_games=g("Testing", "num_mcts_test_games"),
            test_game_index=g("Testing", "test_game_index"),
            goal_rush_opponent=g("Testing", "goal_rush_opponent"),
        ),
    )
    plotting = section(
        PlottingConfig,
        dict(
            plot_loss=g("Plotting", "plot_loss"),
            plot_weights=g("Plotting", "plot_weights"),
            plot_frequency=g("Plotting", "plot_frequency"),
            recent_steps_loss=g("Plotting", "recent_steps_loss"),
        ),
    )
    ti = g("Recurrent Options", "train_iterations")
    pi = g("Recurrent Options", "pred_iterations")
    recurrent = section(
        RecurrentOptions,
        dict(
            train_iterations=tuple(ti) if ti is not None else None,
            pred_iterations=tuple(pi) if pi is not None else None,
            test_iterations=g("Recurrent Options", "test_iterations"),
            alpha=g("Recurrent Options", "alpha"),
        ),
    )
    learning = section(
        LearningConfig,
        dict(
            replay_window_size=g("Learning", "replay_window_size"),
            value_loss=g("Learning", "value_loss"),
            policy_loss=g("Learning", "policy_loss"),
            normalize_cel=g("Learning", "normalize_cel"),
            learning_method=g("Learning", "learning_method"),
            batch_size=g("Learning", "Samples", "batch_size"),
            num_samples=g("Learning", "Samples", "num_samples"),
            with_replacement=g("Learning", "Samples", "with_replacement"),
            late_heavy=g("Learning", "Samples", "late_heavy"),
            epochs_batch_size=g("Learning", "Epochs", "batch_size"),
            learning_epochs=g("Learning", "Epochs", "learning_epochs"),
            plot_epochs=g("Learning", "Epochs", "plot_epochs"),
        ),
    )
    boundaries = g("Scheduler", "scheduler_boundaries")
    optimizer = section(
        OptimizerConfig,
        dict(
            optimizer_choice=g("Optimizer", "optimizer_choice"),
            weight_decay=g("Optimizer", "SGD", "weight_decay"),
            momentum=g("Optimizer", "SGD", "momentum"),
            nesterov=g("Optimizer", "SGD", "nesterov"),
            starting_lr=g("Scheduler", "starting_lr"),
            scheduler_boundaries=(
                tuple(boundaries) if boundaries is not None else None
            ),
            scheduler_gamma=g("Scheduler", "scheduler_gamma"),
        ),
    )
    return TrainingConfig(
        network_name=g("Initialization", "network_name", default=defaults.network_name),
        load_checkpoint=g(
            "Initialization", "load_checkpoint", default=defaults.load_checkpoint
        ),
        checkpoint=checkpoint,
        running=running,
        cache=cache,
        saving=saving,
        testing=testing,
        plotting=plotting,
        recurrent=recurrent,
        learning=learning,
        optimizer=optimizer,
    )


def load_training_config(path: str) -> TrainingConfig:
    return training_config_from_dict(load_yaml(path) or {})


def search_params_from_dict(d: dict) -> SearchParams:
    """Parse the reference search-YAML layout
    (ref ``documentation_search_config.yaml``)."""

    def g(*path, default=None):
        return _get(d, *path, default=default)

    defaults = SearchParams()
    return SearchParams(
        num_simulations=g(
            "Simulation", "mcts_simulations", default=defaults.num_simulations
        ),
        keep_subtree=g("Simulation", "keep_subtree", default=defaults.keep_subtree),
        pb_c_base=g("UCT", "pb_c_base", default=defaults.pb_c_base),
        pb_c_init=g("UCT", "pb_c_init", default=defaults.pb_c_init),
        number_of_softmax_moves=g(
            "Exploration",
            "number_of_softmax_moves",
            default=defaults.number_of_softmax_moves,
        ),
        epsilon_softmax_exploration=g(
            "Exploration",
            "epsilon_softmax_exploration",
            default=defaults.epsilon_softmax_exploration,
        ),
        epsilon_random_exploration=g(
            "Exploration",
            "epsilon_random_exploration",
            default=defaults.epsilon_random_exploration,
        ),
        value_factor=g("Exploration", "value_factor", default=defaults.value_factor),
        root_exploration_fraction=g(
            "Exploration",
            "root_exploration_fraction",
            default=defaults.root_exploration_fraction,
        ),
        root_dist_alpha=g(
            "Exploration", "root_dist_alpha", default=defaults.root_dist_alpha
        ),
        root_dist_beta=g(
            "Exploration", "root_dist_beta", default=defaults.root_dist_beta
        ),
    )


def load_search_config(path: str) -> SearchParams:
    return search_params_from_dict(load_yaml(path) or {})
