"""AlphaZero coordinator: self-play -> replay -> SGD orchestration.

Behavioral target: ``Training/AlphaZero.py`` ``run()`` (ref ``:215-501``) —
early buffer fill with softened exploration, sequential
(play-N-games -> train -> repeat) and asynchronous (interleaved) running
modes, samples/epochs learning methods, periodic checkpoints and in-loop
evaluation.

Design: the Ray actor topology (Gamer pool + ReplayBuffer actor +
RemoteStorage) collapses into an on-device actor-learner.  Self-play,
replay and SGD all operate on device-resident arrays; the host loop only
sequences jitted calls and does IO (journal, checkpoints).  "Asynchronous"
mode interleaves self-play lockstep move-batches with training updates,
honoring ``update_delay``'s wall-clock decoupling: actors keep playing
until ``update_delay`` seconds have elapsed since the previous update (ref
``AlphaZero.py:389-404,468-469,1259-1266``).  In-loop evaluation can run on
a host worker thread (``asynchronous_testing``) so training never stalls on
eval batches (ref ``RemoteTestManager`` + ``AlphaZero.py:1268-1280``).
Weights never leave the device between checkpoint saves (the reference
ships pickled CPU copies through Ray's object store per game —
``AlphaZero.py:291-294``, ``Gamer.py:40``).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from nuzero.config.schemas import TrainingConfig
from nuzero.networks.manager import NetworkManager
from nuzero.search.mcts import SearchParams
from nuzero.training.learner import Learner, LearnerConfig, TrainState
from nuzero.training import replay as replay_lib
from nuzero.training.selfplay import init_selfplay, make_selfplay_step
from nuzero.utils.checkpoint import restore_checkpoint, save_checkpoint
from nuzero.utils.metrics import MetricsJournal
from nuzero.utils.profiling import PhaseTimers


def learner_config_from_training(
    cfg: TrainingConfig, num_game_types: int = 1
) -> LearnerConfig:
    ti = cfg.recurrent.train_iterations
    per_type = (
        tuple(ti[t] if t < len(ti) else ti[0] for t in range(num_game_types))
        if num_game_types > 1
        else ()
    )
    return LearnerConfig(
        train_iterations_per_type=per_type,
        policy_loss=cfg.learning.policy_loss,
        value_loss=cfg.learning.value_loss,
        normalize_policy=cfg.learning.normalize_cel,
        optimizer=cfg.optimizer.optimizer_choice,
        learning_rate=cfg.optimizer.starting_lr,
        scheduler_boundaries=cfg.optimizer.scheduler_boundaries,
        scheduler_gamma=cfg.optimizer.scheduler_gamma,
        weight_decay=cfg.optimizer.weight_decay,
        momentum=cfg.optimizer.momentum,
        nesterov=cfg.optimizer.nesterov,
        train_iterations=cfg.recurrent.train_iterations[0],
        prog_alpha=cfg.recurrent.alpha,
    )


class AlphaZero:
    """Training coordinator (ref class ``AlphaZero``, ``AlphaZero.py:54``)."""

    def __init__(
        self,
        env,
        manager: NetworkManager,
        train_config: TrainingConfig,
        search_params: SearchParams,
        run_dir: Optional[str] = None,
        test_hook: Optional[Callable] = None,
        state_set: Optional[jax.Array] = None,
        mesh=None,
    ):
        """``mesh``: optional ``jax.sharding.Mesh`` with a ``dp`` axis.  When
        given, the self-play game batch and the replay buffer's game axis are
        sharded over the mesh while params/optimizer state stay replicated;
        XLA inserts the gradient all-reduce from the committed input
        shardings.  This replaces the reference's Ray cluster topology
        (Gamer actors spread over nodes + one learner,
        ref ``Training/AlphaZero.py:525-577``) with one SPMD program.

        ``env`` may be a LIST of envs to train one network on several game
        types at once (ref ``game_args_list`` + per-type Gamer pools,
        ``AlphaZero.py:233-235,525-577``): each type gets its own lockstep
        self-play batch and its own recurrent
        ``train_iterations``/``pred_iterations`` entry; training draws one
        sub-batch per type (the ref's recurrent game-index bucketing).  All
        types must share observation/action shapes."""
        envs = list(env) if isinstance(env, (list, tuple)) else [env]
        base = envs[0]
        for e in envs[1:]:
            if (
                tuple(e.observation_shape) != tuple(base.observation_shape)
                or e.num_actions != base.num_actions
            ):
                raise ValueError(
                    "all game types must share observation and action "
                    "shapes (one network serves every type)"
                )
        self.envs = envs
        # Eval/probe env (ref test_game_index knob).
        self.env = envs[
            min(train_config.testing.test_game_index, len(envs) - 1)
        ]
        self.manager = manager
        self.cfg = train_config
        self.search_params = search_params
        self.run_dir = run_dir
        self.mesh = mesh
        if mesh is not None:
            if train_config.running.num_actors % mesh.size:
                raise ValueError(
                    f"num_actors={train_config.running.num_actors} must "
                    f"divide the mesh size {mesh.size}"
                )
            if train_config.learning.replay_window_size % mesh.size:
                raise ValueError(
                    f"replay_window_size={train_config.learning.replay_window_size}"
                    f" must divide the mesh size {mesh.size}"
                )
        if (
            train_config.running.running_mode == "sequential"
            and train_config.running.num_games_per_type_per_step < 1
        ):
            # A 0-game sequential step would train without fresh self-play
            # and leave the per-step stats undefined; reject it up front.
            raise ValueError(
                "sequential running_mode requires "
                "num_games_per_type_per_step >= 1"
            )
        self.test_hook = test_hook  # called (state, step) -> dict of metrics
        # Fixed probe positions whose value-head outputs are tracked per
        # plot step (ref AlphaZero.state_set + update_state_set_data,
        # AlphaZero.py:1175-1179; sets built in Run.py:427-579).
        self.state_set = state_set
        # Multi-controller JAX: every host runs this same coordinator (the
        # reference instead SPREADs Ray actors from one driver,
        # slurm-template.sh:52-63).  Device work is SPMD-symmetric across
        # processes; host-side IO (journal, plots, eval batches) runs on
        # process 0 only.
        self._multiprocess = jax.process_count() > 1
        self._proc0 = jax.process_index() == 0
        if (
            self._multiprocess
            and train_config.running.running_mode == "asynchronous"
        ):
            # The async self-play loop exits on WALL-CLOCK (update_delay);
            # under multi-controller JAX each self-play step is a
            # cross-process collective over the globally sharded state, so
            # hosts that launch different numbers of steps deadlock (or
            # corrupt the run).  Only sequential mode derives its loop
            # bounds from values identical on all processes.
            raise ValueError(
                "running_mode 'asynchronous' is single-process only: its "
                "wall-clock loop exit can diverge across hosts while every "
                "self-play step is a cross-process collective. Use "
                "running_mode 'sequential' for multi-host runs."
            )
        self.journal = MetricsJournal(
            os.path.join(run_dir, "journal.jsonl") if run_dir else None,
            write=self._proc0,
        )

        if train_config.cache.cache_choice not in ("disabled", "none"):
            print(
                "note: Cache.cache_choice is obsolete on this runtime — "
                "self-play leaf inference is batched on-device "
                "(see CacheConfig docstring); ignoring"
            )

        self.learner = Learner(
            manager,
            learner_config_from_training(train_config, len(envs)),
        )

        pi = train_config.recurrent.pred_iterations

        def make_net(pred_iters: int):
            def net(variables, obs):
                p, v, _ = manager.apply(
                    variables, obs, iters_to_do=pred_iters
                )
                return p, v

            return net

        # Early-fill exploration overrides (ref AlphaZero.py:385-387,503-517
        # + Running config early_* keys).
        early_params = dataclasses.replace(
            search_params,
            number_of_softmax_moves=train_config.running.early_softmax_moves,
            epsilon_softmax_exploration=train_config.running.early_softmax_exploration,
            epsilon_random_exploration=train_config.running.early_random_exploration,
        )
        # One self-play engine per game type, each at its own
        # pred_iterations entry; the carried self-play state is donated
        # (its trajectory buffers are the largest live arrays and must not
        # be double-buffered).
        self.sp_steps = []
        self.sp_steps_early = []
        for t, e in enumerate(envs):
            net_t = make_net(pi[t] if t < len(pi) else pi[0])
            self.sp_steps.append(
                jax.jit(
                    make_selfplay_step(
                        e, net_t, search_params, training=True, game_type=t
                    ),
                    donate_argnums=(1,),
                )
            )
            self.sp_steps_early.append(
                jax.jit(
                    make_selfplay_step(
                        e, net_t, early_params, training=True, game_type=t
                    ),
                    donate_argnums=(1,),
                )
            )
        self._net = make_net(
            pi[min(train_config.testing.test_game_index, len(pi) - 1)]
        )
        self.tr_step = jax.jit(self.learner.train_step, donate_argnums=(0,))
        self.tr_step_multi = jax.jit(
            self.learner.train_step_multi, donate_argnums=(0,)
        )

        def probe_values(params, obs):
            _, v = self._net(params, obs)
            return v

        self._probe_values = jax.jit(probe_values)

        def weight_stats(params):
            # |weight| max/min/mean over ALL parameters, the reference's
            # three weight-size series (ref update_weight_data,
            # AlphaZero.py:1164-1173).
            leaves = [jnp.abs(x.reshape(-1)) for x in jax.tree.leaves(params)]
            sizes = jnp.asarray([x.size for x in leaves], jnp.float32)
            return (
                jnp.max(jnp.asarray([x.max() for x in leaves])),
                jnp.min(jnp.asarray([x.min() for x in leaves])),
                jnp.sum(jnp.asarray([x.mean() for x in leaves]) * sizes)
                / sizes.sum(),
            )

        self._weight_stats = jax.jit(weight_stats)
        self.add_games = jax.jit(replay_lib.add_games, donate_argnums=(0,))
        # The buffer stores packed env states (see replay.py docstring);
        # each game type's sampler regenerates observations from the drawn
        # positions with ITS env's observe (types may pack to different
        # widths — rows are padded to the max).
        from nuzero.utils.packing import make_packer

        self._packers = [make_packer(e.init(jax.random.key(0))) for e in envs]
        self.state_dim = max(d for _, _, d in self._packers)

        def make_sampler(env_t, unpack_t, dim_t):
            def sample_obs(buffer, rng, batch_size, *, late_heavy,
                           with_replacement, game_type=None):
                enc, pol, val, gt = replay_lib.sample(
                    buffer, rng, batch_size,
                    late_heavy=late_heavy,
                    with_replacement=with_replacement,
                    game_type=game_type,
                )
                obs = jax.vmap(lambda v: env_t.observe(unpack_t(v[:dim_t])))(
                    enc
                )
                return obs, pol, val, gt

            return jax.jit(
                sample_obs,
                static_argnums=(2,),
                static_argnames=("late_heavy", "with_replacement"),
            )

        self._samplers = [
            make_sampler(e, up, d)
            for e, (_, up, d) in zip(envs, self._packers)
        ]

        # Epochs learning method: exact shuffle-and-sweep batch extraction
        # (ref AlphaZero.py:686-737) — a per-epoch permutation of valid
        # positions sliced into batches, instead of independent draws.
        def make_epoch_sampler(env_t, unpack_t, dim_t):
            def gather_obs(buffer, idx):
                enc, pol, val, gt = replay_lib.gather(buffer, idx)
                obs = jax.vmap(lambda v: env_t.observe(unpack_t(v[:dim_t])))(
                    enc
                )
                return obs, pol, val, gt

            return jax.jit(gather_obs)

        self._epoch_samplers = [
            make_epoch_sampler(e, up, d)
            for e, (_, up, d) in zip(envs, self._packers)
        ]
        self._epoch_perm = jax.jit(
            replay_lib.epoch_permutation, static_argnames=("game_type",)
        )
        self.trajectory_length = train_config.running.max_trajectory_length or max(
            e.max_game_length for e in envs
        )

        # In-loop evaluation vs RandomAgent, policy/mcts x both seats
        # (ref AlphaZero.run_tests, AlphaZero.py:596-645).  Test agents run
        # at test_iterations recurrent steps (ref uses the Testing config's
        # iteration count, not pred_iterations).
        from nuzero.evaluation import (
            MctsAgent,
            PolicyAgent,
            RandomAgent,
            TestManager,
        )

        test_iters = train_config.recurrent.test_iterations
        self.test_manager = TestManager(env, train_config.testing.testing_actors)
        self._random_agent = RandomAgent()
        self._policy_agent = PolicyAgent(manager, None, test_iters)
        self._mcts_agent = MctsAgent(
            manager, None, search_params, test_iters
        )
        self._goal_rush_agent = None
        if train_config.testing.goal_rush_opponent:
            from nuzero.evaluation import GoalRushAgent

            self._goal_rush_agent = GoalRushAgent()
        # Asynchronous testing (ref RemoteTestManager +
        # AlphaZero.py:347-349,613-627,1268-1280): eval batches run on a
        # host worker thread and are harvested without blocking training.
        # JAX arrays are immutable, so the snapshot of params handed to the
        # thread is free (the reference ships pickled CPU copies).
        self._test_executor = None
        self._pending_tests: list = []
        if train_config.testing.asynchronous_testing:
            import concurrent.futures

            self._test_executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="nuzero-eval"
            )
        self._sp_batches = 0  # move-batches launched this step (throughput)
        self.buffer = replay_lib.create_buffer(
            train_config.learning.replay_window_size,
            self.trajectory_length,
            self.state_dim,
            base.num_actions,
        )

    # -- phases --------------------------------------------------------------

    # How many in-flight move-batches the host runs ahead of the device.
    # int() on a batch's finished-count forces a device->host round trip;
    # syncing on the count from PIPELINE_DEPTH batches ago instead of the
    # batch just launched keeps the device queue full (a per-move sync
    # would leave the device idle while the host waits).
    PIPELINE_DEPTH = 3

    def _selfplay_until(self, state, sp, step_fn, target_games: int,
                        progress=None):
        """Run lockstep move-batches until ``target_games`` finish.

        The finished-count the loop condition reads lags PIPELINE_DEPTH
        batches behind the device, so up to that many extra move-batches
        run past the target — they land in the buffer and are counted in
        the returned total (the reference's actor pool overshoots the
        same way: every in-flight Gamer finishes its game,
        ``AlphaZero.py:525-577``)."""
        from collections import deque

        done = 0
        stats = {}
        pending: deque = deque()
        while done < target_games:
            sp, finished, stats = step_fn(state.params, sp)
            self._sp_batches += 1
            self.buffer = self.add_games(self.buffer, finished)
            pending.append(stats["finished"])
            if len(pending) > self.PIPELINE_DEPTH:
                n = int(pending.popleft())
                done += n
                if progress is not None and n:
                    progress(n)
        for f in pending:
            n = int(f)
            done += n
            if progress is not None and n:
                progress(n)
        return sp, done, stats

    def _one_update(self, state, k_s, k_t, batch_size, *, late_heavy,
                    with_replacement):
        """One SGD update: a single mixed batch for one game type, or one
        sub-batch per type forwarded at its own recurrent iteration count
        (ref recurrent game-index bucketing, ``AlphaZero.py:846-870``)."""
        T = len(self.envs)
        if T == 1:
            batch = self._samplers[0](
                self.buffer,
                k_s,
                batch_size,
                late_heavy=late_heavy,
                with_replacement=with_replacement,
            )
            return self.tr_step(state, batch, k_t)
        batches = []
        for t in range(T):
            k_s, k_sub = jax.random.split(k_s)
            # Distribute the remainder over the first batch_size % T types
            # so the update trains on exactly batch_size samples.
            sub_size = batch_size // T + (1 if t < batch_size % T else 0)
            batches.append(
                self._samplers[t](
                    self.buffer,
                    k_sub,
                    sub_size,
                    late_heavy=late_heavy,
                    with_replacement=with_replacement,
                    game_type=t,
                )
            )
        return self.tr_step_multi(state, tuple(batches), k_t)

    def _train_once(self, state: TrainState, rng):
        cfg = self.cfg.learning
        metrics = {}
        if cfg.learning_method == "samples":
            for _ in range(cfg.num_samples):
                rng, k_s, k_t = jax.random.split(rng, 3)
                state, metrics = self._one_update(
                    state, k_s, k_t, cfg.batch_size,
                    late_heavy=cfg.late_heavy,
                    with_replacement=cfg.with_replacement,
                )
        elif cfg.learning_method == "epochs":
            # Exact shuffle-and-sweep (ref AlphaZero.py:686-737): each epoch
            # permutes the valid positions once and slices full batches in
            # order — every position visited at most once per epoch, with
            # the n_positions % batch_size remainder dropped (like the
            # reference's replay_size // batch_size slicing).
            T = len(self.envs)
            bs = cfg.epochs_batch_size
            sub_sizes = [
                bs // T + (1 if t < bs % T else 0) for t in range(T)
            ]
            n_pos = [
                int(
                    jnp.where(
                        self.buffer.game_type == t, self.buffer.length, 0
                    ).sum()
                )
                if T > 1
                else int(self.buffer.num_positions)
                for t in range(T)
            ]
            for t in range(T):
                if sub_sizes[t] > n_pos[t]:
                    raise ValueError(
                        "Batch size too large; use early_fill to pre-fill "
                        "the replay buffer (ref AlphaZero.py:690-693)"
                    )
            n_batches = min(n_pos[t] // sub_sizes[t] for t in range(T))
            for e in range(cfg.learning_epochs):
                perms = []
                for t in range(T):
                    rng, k_p = jax.random.split(rng)
                    perms.append(
                        self._epoch_perm(
                            self.buffer, k_p,
                            game_type=t if T > 1 else None,
                        )
                    )
                ep_loss = 0.0
                for b in range(n_batches):
                    rng, k_t = jax.random.split(rng)
                    batches = tuple(
                        self._epoch_samplers[t](
                            self.buffer,
                            perms[t][b * sub_sizes[t]:(b + 1) * sub_sizes[t]],
                        )
                        for t in range(T)
                    )
                    if T == 1:
                        state, metrics = self.tr_step(state, batches[0], k_t)
                    else:
                        state, metrics = self.tr_step_multi(state, batches, k_t)
                    ep_loss += float(metrics["loss/combined"])
                if cfg.plot_epochs and n_batches:
                    # Per-epoch mean loss series (ref epochs_*_loss plots,
                    # AlphaZero.py:704-708).
                    metrics[f"loss/epoch{e}"] = ep_loss / n_batches
        else:
            raise ValueError(f"bad learning_method {cfg.learning_method!r}")
        return state, rng, metrics

    def _inloop_test_job(self, params, step: int) -> dict:
        """One eval batch: policy/MCTS agents vs RandomAgent on both seats
        (ref AlphaZero.py:596-645: test types p1_policy/p2_policy/
        p1_mcts/p2_mcts).  Runs inline, or on the eval worker thread when
        asynchronous_testing is on."""
        cfg = self.cfg.testing
        out = {}

        def run(agent, n_games, tag, seed, opponent=None, suffix=""):
            opponent = opponent or self._random_agent
            agent.set_network(params)
            s_p0 = self.test_manager.run_test_batch(
                n_games, agent, opponent,
                jax.random.key(seed), show_results=False,
            )
            s_p1 = self.test_manager.run_test_batch(
                n_games, opponent, agent,
                jax.random.key(seed + 1), show_results=False,
            )
            out[f"wr/{tag}{suffix}_as_p0"] = s_p0.p0_win_rate
            out[f"wr/{tag}{suffix}_as_p1"] = s_p1.p1_win_rate
            out[f"nonloss/{tag}{suffix}_as_p0"] = 1.0 - s_p0.p1_win_rate
            out[f"nonloss/{tag}{suffix}_as_p1"] = 1.0 - s_p1.p0_win_rate

        gr = self._goal_rush_agent
        if cfg.policy_test_frequency and step % cfg.policy_test_frequency == 0:
            run(self._policy_agent, cfg.num_policy_test_games, "policy", 2 * step)
            if gr is not None:
                run(self._policy_agent, cfg.num_policy_test_games, "policy",
                    2 * step + 10_000_001, opponent=gr, suffix="_vs_gr")
        if cfg.mcts_test_frequency and step % cfg.mcts_test_frequency == 0:
            run(self._mcts_agent, cfg.num_mcts_test_games, "mcts", 2 * step + 1)
            if gr is not None:
                run(self._mcts_agent, cfg.num_mcts_test_games, "mcts",
                    2 * step + 10_000_002, opponent=gr, suffix="_vs_gr")
        return out

    def _tests_due(self, step: int) -> bool:
        cfg = self.cfg.testing
        return bool(
            (cfg.policy_test_frequency and step % cfg.policy_test_frequency == 0)
            or (cfg.mcts_test_frequency and step % cfg.mcts_test_frequency == 0)
        )

    def _run_inloop_tests(self, state: TrainState, step: int) -> dict:
        if not self._tests_due(step):
            return {}
        if self._multiprocess:
            # Cross-process run: the arena's game batch lives on LOCAL
            # devices, so it must not mix with globally-sharded params in
            # one jit (and proc-0-only launches of global computations
            # would deadlock the other hosts).  Process 0 evaluates with a
            # host copy of the (replicated) params on its own devices;
            # the rest skip — eval work is not SPMD.
            if not self._proc0:
                return {}
            params = jax.device_get(state.params)
        elif self._test_executor is not None:
            # Async: the train step DONATES the TrainState buffers, so the
            # eval thread needs its own device copy of the params (the
            # reference ships pickled CPU copies through the object store —
            # here it's one device-to-device copy).
            params = jax.tree.map(jnp.copy, state.params)
        else:
            params = state.params
        if self._test_executor is None:
            return self._inloop_test_job(params, step)
        # Jobs serialize on the single worker, so the shared test agents
        # are never raced.
        self._pending_tests.append(
            (step, self._test_executor.submit(
                self._inloop_test_job, params, step
            ))
        )
        return {}

    def _harvest_async_tests(self, block: bool = False) -> None:
        """Journal finished async eval batches under their launch step (ref
        ``check_pending_tests`` harvest + in-order insert,
        ``AlphaZero.py:1268-1280,1139-1162`` — JSONL records carry their own
        step, so append order doesn't matter to consumers)."""
        remaining = []
        for step, fut in self._pending_tests:
            if block or fut.done():
                res = fut.result()
                if res:
                    self.journal.append(
                        {"step": step, "async_test": True, **res}
                    )
            else:
                remaining.append((step, fut))
        self._pending_tests = remaining

    # -- main loop -----------------------------------------------------------

    def run(
        self,
        seed: int = 0,
        initial_state: Optional[TrainState] = None,
        starting_step: int = 0,
    ) -> TrainState:
        cfg = self.cfg
        rng = jax.random.key(seed)
        rng, k_init = jax.random.split(rng)
        state = initial_state or self.learner.init_state(k_init)
        sps = []
        for t, e in enumerate(self.envs):
            rng, k_sp = jax.random.split(rng)
            sps.append(
                init_selfplay(
                    e,
                    cfg.running.num_actors,
                    k_sp,
                    self.trajectory_length,
                    search_params=self.search_params,
                    state_dim=self.state_dim,
                )
            )
        if self.mesh is not None:
            # Commit the carried pytrees to their mesh shardings once; the
            # donated jitted steps preserve them for the whole run.
            from nuzero.parallel.mesh import (
                place_batch_sharded,
                place_replicated,
            )

            state = place_replicated(state, self.mesh)
            sps = [place_batch_sharded(sp, self.mesh) for sp in sps]
            self.buffer = place_batch_sharded(self.buffer, self.mesh)
            if self.state_set is not None:
                # Probe inputs replicated on the SAME mesh so the probe jit
                # stays SPMD-symmetric across processes (a local state_set
                # mixed with global params is an invalid jit input set).
                self.state_set = place_replicated(self.state_set, self.mesh)

        if cfg.running.early_fill_per_type > 0 and starting_step == 0:
            from nuzero.utils.printbar import PrintBar

            t0 = time.time()
            total = 0
            bar = None
            if self._proc0:
                bar = PrintBar(
                    "early fill",
                    len(self.envs) * cfg.running.early_fill_per_type,
                )
            for t in range(len(self.envs)):
                sps[t], n, _ = self._selfplay_until(
                    state,
                    sps[t],
                    self.sp_steps_early[t],
                    cfg.running.early_fill_per_type,
                    progress=bar.next if bar else None,
                )
                total += n
            # num_positions is a COMPUTED property (a sum over the
            # dp-sharded length array): in multi-controller it is a
            # cross-process collective and must be launched by every
            # process, so it cannot live inside the proc-0 print.
            n_pos = int(self.buffer.num_positions)
            if bar:
                bar.finish()
                print(
                    f"early fill: {total} games in {time.time() - t0:.1f}s "
                    f"({n_pos} positions)"
                )

        if (
            cfg.testing.early_testing
            and starting_step == 0
            and self.test_hook is None
        ):
            # Baseline eval before any update (ref early_testing knob +
            # AlphaZero.py run_tests at step 0).
            res = self._run_inloop_tests(state, 0)
            if res:
                self.journal.append({"step": 0, **res})

        sequential = cfg.running.running_mode == "sequential"
        T = len(self.envs)
        timers = PhaseTimers()
        # Optional model-FLOPs accounting for journal MFU (one extra
        # compile of the train step — opt in with NUZERO_MFU=1; bench.py
        # always reports MFU for the benchmark legs).
        train_flops = None
        if os.environ.get("NUZERO_MFU") and not self._multiprocess:
            try:
                bs = (
                    cfg.learning.batch_size
                    if cfg.learning.learning_method == "samples"
                    else cfg.learning.epochs_batch_size
                )
                obs = jnp.zeros(
                    (max(bs // T, 1),) + tuple(self.env.observation_shape),
                    jnp.float32,
                )
                cost = (
                    jax.jit(lambda v, o: self._net(v, o))
                    .lower(state.params, obs)
                    .compile()
                    .cost_analysis()
                )
                if isinstance(cost, list):
                    cost = cost[0]
                # forward + backward ~ 3x forward FLOPs per update.
                train_flops = 3.0 * float(cost.get("flops", 0.0))
            except Exception:
                train_flops = None
        # Optional jax.profiler capture of a few steady-state steps
        # (SURVEY §5.1; the reference has no profiler at all).
        trace_dir = os.environ.get("NUZERO_TRACE_DIR")
        trace_at = starting_step + 2
        for step in range(starting_step + 1, cfg.running.training_steps + 1):
            t0 = time.time()
            self._sp_batches = 0
            if trace_dir and step == trace_at:
                jax.profiler.start_trace(trace_dir)
            if sequential:
                games = 0
                per_type_stats = {}
                with timers.phase("selfplay"):
                    for t in range(T):
                        sps[t], g, sp_stats = self._selfplay_until(
                            state,
                            sps[t],
                            self.sp_steps[t],
                            cfg.running.num_games_per_type_per_step,
                        )
                        games += g
                        if T > 1:
                            per_type_stats[t] = (g, sp_stats)
            else:
                # Asynchronous mode: actors play continuously; the learner
                # rate is set by update_delay (ref wall-clock-decoupled mode,
                # AlphaZero.py:389-404,468-469,1259-1266) — self-play
                # move-batches keep running until update_delay seconds have
                # elapsed since the last update (always at least one batch,
                # round-robin over game types).
                games = 0
                with timers.phase("selfplay"):
                    from collections import deque

                    pending: deque = deque()
                    while True:
                        for t in range(T):
                            sps[t], finished, sp_stats = self.sp_steps[t](
                                state.params, sps[t]
                            )
                            self._sp_batches += 1
                            self.buffer = self.add_games(self.buffer, finished)
                            pending.append(sp_stats["finished"])
                        # Pipelined sync (see _selfplay_until): pace the
                        # host to the device by blocking on the count from
                        # PIPELINE_DEPTH batches ago, not the one just
                        # launched — otherwise wall-clock pacing would let
                        # the host enqueue unboundedly far ahead.
                        while len(pending) > self.PIPELINE_DEPTH:
                            games += int(pending.popleft())
                        if time.time() - t0 >= cfg.running.update_delay:
                            break
                    for f in pending:
                        games += int(f)

            rng, k_t = jax.random.split(rng)
            updates_before = int(state.step)
            with timers.phase("train"):
                state, rng, tr_metrics = self._train_once(state, k_t)

            record = {
                "step": step,
                "games": games,
                "buffer_games": int(self.buffer.num_games),
                "buffer_positions": int(self.buffer.num_positions),
                # Insertion count at this step — the step_to_size_map
                # equivalent enabling partial buffer loads
                # (ref ReplayBuffer.py:64-104).
                "buffer_seq": int(self.buffer.games_added),
                "updates": int(state.step),
                "loss/combined": float(tr_metrics.get("loss/combined", np.nan)),
                "loss/policy": float(tr_metrics.get("loss/policy", np.nan)),
                "loss/value": float(tr_metrics.get("loss/value", np.nan)),
                "selfplay/root_value": float(
                    sp_stats.get("root_value_mean", np.nan)
                ),
                "selfplay/tree_full_frac": float(
                    sp_stats.get("tree_full_frac", 0.0)
                ),
                # Avg materialized children per allocated tree node (ref
                # Gamer per-game MCTS stats, Training/Gamer.py:42-92).
                "selfplay/children_per_node": float(
                    sp_stats.get("children_per_node_mean", np.nan)
                ),
                "step_time_s": time.time() - t0,
            }
            # Training-loop search throughput: MCTS-backed env-steps/s over
            # this step's self-play phase — directly comparable to
            # bench.py's pure-device-loop number (the gap is host overhead;
            # see PIPELINE_DEPTH).
            sp_time = timers._last.get("selfplay", 0.0)
            if self._sp_batches and sp_time > 0:
                record["selfplay/env_steps_per_s"] = round(
                    self._sp_batches
                    * cfg.running.num_actors
                    * self.search_params.num_simulations
                    / sp_time
                )
            for k, v in tr_metrics.items():
                if k.startswith("loss/type"):
                    record[k] = float(v)
            if sequential and T > 1:
                # Per-game-type averaged self-play stats (ref per-type
                # Gamer stats printing, Training/Gamer.py:42-92 +
                # stats_utils.py:21-35 — journaled instead of printed).
                for t, (g, st) in per_type_stats.items():
                    record[f"selfplay/type{t}/games"] = g
                    for key_in, key_out in (
                        ("root_value_mean", "root_value"),
                        ("tree_nodes_mean", "tree_nodes"),
                        ("children_per_node_mean", "children_per_node"),
                        ("exploration_bias_mean", "exploration_bias"),
                    ):
                        if key_in in st:
                            record[f"selfplay/type{t}/{key_out}"] = float(
                                st[key_in]
                            )

            with timers.phase("eval"):
                if self.test_hook is not None:
                    freq = cfg.testing.policy_test_frequency
                    if freq and step % freq == 0:
                        record.update(self.test_hook(state, step) or {})
                else:
                    record.update(self._run_inloop_tests(state, step))
                self._harvest_async_tests()

            if (
                self.state_set is not None
                and step % cfg.plotting.plot_frequency == 0
            ):
                values = np.asarray(
                    self._probe_values(state.params, self.state_set)
                ).reshape(-1)
                record.update(
                    {f"value_probe/{i}": float(v) for i, v in enumerate(values)}
                )
            if (
                cfg.plotting.plot_weights
                and step % cfg.plotting.plot_frequency == 0
            ):
                w_max, w_min, w_mean = self._weight_stats(state.params)
                record.update(
                    {
                        "weights/abs_max": float(w_max),
                        "weights/abs_min": float(w_min),
                        "weights/abs_mean": float(w_mean),
                    }
                )

            if train_flops:
                # Model FLOP/s across this step's updates (forward+backward
                # at the train batch size; self-play/search excluded).
                n_updates = int(state.step) - updates_before
                record["train_flops_per_s"] = round(
                    train_flops * max(n_updates, 0)
                    / max(time.time() - t0, 1e-9)
                )
            record.update(timers.metrics())
            self.journal.append(record)
            if trace_dir and step == trace_at:
                jax.profiler.stop_trace()

            if self.run_dir and step % cfg.saving.save_frequency == 0:
                with timers.phase("checkpoint"):
                    tree = {
                        "params": state.params,
                        "opt_state": state.opt_state,
                        "step": state.step,
                        # Host numpy: identical on every process, so Orbax
                        # treats it as replicated (primary-host write).
                        "rng": np.asarray(jax.random.key_data(rng)),
                    }
                    if cfg.saving.save_buffer:
                        tree["buffer"] = self.buffer
                    save_checkpoint(
                        os.path.join(self.run_dir, "checkpoints"), step, tree
                    )
                # Refresh the plot set beside the checkpoints (ref in-loop
                # rendering every plot_frequency steps,
                # AlphaZero.py:429-451; here rendering rides the checkpoint
                # cadence so the hot loop never blocks on matplotlib).
                self.render_plots()

        self._harvest_async_tests(block=True)
        if self.run_dir:
            self.render_plots()
        return state

    def render_plots(self) -> list:
        """Render the training plot set from the journal into
        ``run_dir/plots`` (ref plot rendering,
        ``AlphaZero.py:963-1179``).  Returns written paths."""
        if self.run_dir is None or not self._proc0:
            return []
        from nuzero.utils.plots import plot_training_run

        records = self.journal.load()
        if not records:
            return []
        return plot_training_run(
            records,
            os.path.join(self.run_dir, "plots"),
            recent_steps=self.cfg.plotting.recent_steps_loss,
            include_loss=self.cfg.plotting.plot_loss,
        )

    # -- resume --------------------------------------------------------------

    def load_buffer_at_step(self, step: int) -> bool:
        """Restore the replay buffer to its state at training step ``step``
        from the NEWEST buffer-bearing checkpoint, dropping games inserted
        after that step (ref ``ReplayBuffer.py:80-104`` partial load by
        ``step_to_size_map``; the insertion count per step lives in the
        journal's ``buffer_seq``).  Returns True on success."""
        assert self.run_dir is not None
        from nuzero.utils.checkpoint import latest_step

        root = os.path.join(self.run_dir, "checkpoints")
        newest = latest_step(root)
        if newest is None:
            return False
        seq_at_step = None
        for rec in self.journal.load():
            if rec.get("step") == step and "buffer_seq" in rec:
                seq_at_step = rec["buffer_seq"]
                break
        if seq_at_step is None:
            return False
        template_state = self.learner.init_state(jax.random.key(0))
        template = {
            "params": template_state.params,
            "opt_state": template_state.opt_state,
            "step": template_state.step,
            "rng": jax.random.key_data(jax.random.key(0)),
            "buffer": self.buffer,
        }
        try:
            tree, _ = restore_checkpoint(root, newest, template)
        except Exception:
            return False
        if tree.get("buffer") is None:
            return False
        self.buffer = replay_lib.truncate_to_seq(tree["buffer"], seq_at_step)
        return True

    def load(self, step: int | str = "auto") -> tuple[TrainState, int]:
        """Restore params/opt/buffer from this run's checkpoints
        (ref ``AlphaZero.py:110-146`` + ``ReplayBuffer.py:80-104``)."""
        assert self.run_dir is not None
        template_state = self.learner.init_state(jax.random.key(0))
        template = {
            "params": template_state.params,
            "opt_state": template_state.opt_state,
            "step": template_state.step,
            "rng": jax.random.key_data(jax.random.key(0)),
        }
        if self.cfg.saving.save_buffer and self.cfg.checkpoint.load_buffer:
            template["buffer"] = self.buffer
        tree, step = restore_checkpoint(
            os.path.join(self.run_dir, "checkpoints"), step, template
        )
        if "buffer" in tree and tree["buffer"] is not None:
            self.buffer = tree["buffer"]
        elif self.cfg.checkpoint.load_buffer:
            # Partial load: this checkpoint carries no buffer, so restore
            # the newest saved one truncated to its state at this step
            # (ref ReplayBuffer.py:80-104 step_to_size_map semantics).
            self.load_buffer_at_step(step)
        ckpt = self.cfg.checkpoint
        opt_state = (
            tree["opt_state"]
            if ckpt.keep_optimizer
            else self.learner.tx.init(tree["params"])
        )
        # keep_scheduler: resume or restart the LR schedule independently of
        # the optimizer moments (ref AlphaZero.py:110-146).
        opt_state = self.learner.set_schedule_count(
            opt_state, tree["step"] if ckpt.keep_scheduler else 0
        )
        state = TrainState(
            params=tree["params"],
            opt_state=opt_state,
            step=jnp.int32(0) if ckpt.fresh_start else tree["step"],
        )
        if ckpt.fresh_start:
            step = 0
        if ckpt.new_plots:
            self.journal.truncate_to_step(0)
        else:
            self.journal.truncate_to_step(step)
        return state, step
