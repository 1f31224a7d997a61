"""SGD learner: optimizer factory, LR schedule, jitted train step.

Behavioral target: ``Training/AlphaZero.py`` training methods —
``batch_update_weights`` (ref ``:836-889``), ``calculate_loss``
(ref ``:891-939``), progressive DeepThinking loss with a random n/k split
and detached interim thought (ref ``:941-955``), optimizer construction
(ref ``Utils/Functions/general_utils.py:24-34``: Adam(lr) or
SGD(momentum, weight_decay, nesterov)), and the per-update MultiStepLR
schedule (ref ``AlphaZero.py:148-154,886``).

Design: the whole update (forward, both progressive branches,
backward, optimizer) is ONE jitted function.  The reference's per-sample
Python loss loop becomes batched reductions (see ``losses.py``); its host
``randrange`` n/k draw becomes an on-device draw feeding the recurrent
scan's dynamic detach/limit scalars, so every (n, k) pair shares one
compiled program.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import optax
from nuzero.utils import struct

from nuzero.networks.manager import NetworkManager
from nuzero.training import losses


@struct.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: jax.Array  # i32 number of applied updates


@dataclasses.dataclass(frozen=True)
class LearnerConfig:
    """Static learner hyperparameters (training-config YAML subset)."""

    policy_loss: str = "CEL"
    value_loss: str = "SE"
    normalize_policy: bool = False
    optimizer: str = "Adam"
    learning_rate: float = 5.0e-5
    scheduler_boundaries: Tuple[int, ...] = ()
    scheduler_gamma: float = 0.5
    weight_decay: float = 1.0e-7
    momentum: float = 0.9
    nesterov: bool = False
    train_iterations: int = 2  # recurrent nets only
    prog_alpha: float = 0.0  # progressive loss mix; 0 = disabled
    # Per-game-type recurrent iteration counts for multi-game-type runs
    # (ref train_iterations is a list indexed by game type,
    # ``AlphaZero.py:233-235,846-870``).  Empty = single type.
    train_iterations_per_type: Tuple[int, ...] = ()


class Learner:
    def __init__(self, manager: NetworkManager, config: LearnerConfig):
        self.manager = manager
        self.config = config

        schedule = optax.piecewise_constant_schedule(
            init_value=config.learning_rate,
            boundaries_and_scales={
                int(b): config.scheduler_gamma for b in config.scheduler_boundaries
            },
        )
        if config.optimizer == "Adam":
            tx = optax.adam(schedule)
        elif config.optimizer == "SGD":
            tx = optax.chain(
                optax.add_decayed_weights(config.weight_decay),
                optax.sgd(
                    schedule,
                    momentum=config.momentum,
                    nesterov=config.nesterov,
                ),
            )
        else:
            # ref general_utils.py:32-34: bad config falls back to Adam.
            tx = optax.adam(schedule)
        self.tx = tx

    @staticmethod
    def set_schedule_count(opt_state, count):
        """Overwrite the LR-schedule position inside an optimizer state.

        Implements the reference's independent ``keep_scheduler`` resume
        switch (ref ``AlphaZero.py:110-146``: keep the loaded MultiStepLR
        state, or build a fresh scheduler at the initial LR): optax keeps
        the schedule step in ``ScaleByScheduleState.count`` — reset it to 0
        for a fresh schedule, or to the restored update count to resume it.
        """
        count = jnp.asarray(count, jnp.int32)

        def fix(node):
            if isinstance(node, optax.ScaleByScheduleState):
                return optax.ScaleByScheduleState(count=count)
            return node

        return jax.tree.map(
            fix,
            opt_state,
            is_leaf=lambda n: isinstance(n, optax.ScaleByScheduleState),
        )

    def init_state(self, key: jax.Array) -> TrainState:
        params = self.manager.init(key)
        return TrainState(
            params=params,
            opt_state=self.tx.init(params),
            step=jnp.int32(0),
        )

    # -- loss -----------------------------------------------------------------

    def _forward_loss(
        self, params, obs, policy_target, value_target, rng, train_iters=None
    ):
        cfg = self.config
        mgr = self.manager

        def one_loss(p_logits, v_pred):
            return losses.combined_loss(
                p_logits,
                v_pred,
                policy_target,
                value_target,
                policy_loss=cfg.policy_loss,
                value_loss=cfg.value_loss,
                normalize_policy=cfg.normalize_policy,
            )

        if not mgr.is_recurrent:
            p, v, _ = mgr.apply(params, obs, train=True)
            v_l, p_l, c_l = one_loss(p, v)
            return c_l, (v_l, p_l)

        m = cfg.train_iterations if train_iters is None else train_iters
        alpha = cfg.prog_alpha
        v_l = p_l = c_l = 0.0
        if alpha != 1.0:
            (pf, vf), _ = mgr.module.apply(
                params, obs, m, None, True
            )
            v_f, p_f, c_f = one_loss(pf, vf)
            v_l += (1 - alpha) * v_f
            p_l += (1 - alpha) * p_f
            c_l += (1 - alpha) * c_f
        if alpha != 0.0:
            # n ~ U{0..m-1}, k ~ U{1..m-n} (ref AlphaZero.py:941-946).
            k_n, k_k = jax.random.split(rng)
            n = jax.random.randint(k_n, (), 0, m)
            k = jax.random.randint(k_k, (), 1, m - n + 1)
            detach_at = jnp.where(n > 0, n, -1)  # n=0: no detach (ref :948-952)
            (pp, vp), _ = mgr.module.apply(
                params, obs, m, None, True, detach_at, n + k
            )
            v_p, p_p, c_p = one_loss(pp, vp)
            v_l += alpha * v_p
            p_l += alpha * p_p
            c_l += alpha * c_p
        return c_l, (v_l, p_l)

    # -- update ---------------------------------------------------------------

    def train_step(self, state: TrainState, batch, rng: jax.Array):
        """One SGD update.  ``batch`` = (obs, policy_target, value_target,
        game_type).  Jit (or shard_map) this at the call site."""
        obs, policy_target, value_target, _ = batch
        (c_l, (v_l, p_l)), grads = jax.value_and_grad(
            self._forward_loss, has_aux=True
        )(state.params, obs, policy_target, value_target, rng)
        updates, opt_state = self.tx.update(
            grads, state.opt_state, state.params
        )
        params = optax.apply_updates(state.params, updates)
        new_state = TrainState(
            params=params, opt_state=opt_state, step=state.step + 1
        )
        metrics = {
            "loss/value": v_l,
            "loss/policy": p_l,
            "loss/combined": c_l,
            "grad_norm": optax.global_norm(grads),
        }
        return new_state, metrics

    def train_step_multi(self, state: TrainState, batches, rng: jax.Array):
        """One SGD update over per-game-type sub-batches, each forwarded at
        its own recurrent iteration count (ref recurrent batch bucketing by
        game index + per-type train_iterations,
        ``AlphaZero.py:233-235,846-870``).  ``batches`` is a tuple of
        (obs, policy_target, value_target, game_type) tuples, one per type;
        the combined loss is the position-weighted mean across types."""
        iters = self.config.train_iterations_per_type or tuple(
            self.config.train_iterations for _ in batches
        )

        def loss_fn(params):
            tot_c = tot_v = tot_p = 0.0
            n = 0
            per_type = {}
            for t, (obs, pt, vt, _) in enumerate(batches):
                k = jax.random.fold_in(rng, t)
                c_l, (v_l, p_l) = self._forward_loss(
                    params, obs, pt, vt, k, train_iters=iters[t]
                )
                b = obs.shape[0]
                tot_c += c_l * b
                tot_v += v_l * b
                tot_p += p_l * b
                n += b
                per_type[f"loss/type{t}"] = c_l
            return tot_c / n, (tot_v / n, tot_p / n, per_type)

        (c_l, (v_l, p_l, per_type)), grads = jax.value_and_grad(
            loss_fn, has_aux=True
        )(state.params)
        updates, opt_state = self.tx.update(
            grads, state.opt_state, state.params
        )
        params = optax.apply_updates(state.params, updates)
        new_state = TrainState(
            params=params, opt_state=opt_state, step=state.step + 1
        )
        metrics = {
            "loss/value": v_l,
            "loss/policy": p_l,
            "loss/combined": c_l,
            "grad_norm": optax.global_norm(grads),
            **per_type,
        }
        return new_state, metrics
