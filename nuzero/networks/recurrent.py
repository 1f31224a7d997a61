"""DeepThinking-style recurrent network (ref ``Architectures/RecurrentNet.py``).

The recurrent block is applied ``iters_to_do`` times with *shared* weights;
with ``recall=True`` the raw input is concatenated onto the thought tensor
before every iteration (ref ``RecurrentNet.py:82-99``).  Iteration count is
a *test-time* knob: networks trained at k iterations are evaluated at m >> k
to extrapolate (SURVEY §5.7).

Design: the iteration loop is a ``lax.scan`` whose body reads the one set
of cell parameters every iteration — constant compile time at any iteration
count, no Python-loop unrolling.  The interim thought
is threaded in/out so training can resume from a detached interim state.

Progressive-loss support (ref ``Training/AlphaZero.py:941-955``): the
reference runs n iterations, detaches, then k more.  Rather than recompiling
for every (n, k) draw, the scan takes *dynamic* ``detach_at`` and ``limit``
scalars: iteration i applies ``stop_gradient`` to the carry when
``i == detach_at`` and becomes an identity (masked) once ``i >= limit``, so
the final carry equals the thought after ``limit`` iterations with gradients
cut at ``detach_at`` — same semantics, one compiled program for all (n, k).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from nuzero.networks import core as nn
from nuzero.networks.blocks import (
    BasicBlock,
    Conv,
    ReducePolicyHead,
    make_value_head,
)


class _RecurCell(nn.Module):
    num_filters: int
    num_blocks: int
    recall: bool
    hex: bool
    dtype: jnp.dtype

    def __call__(self, carry, i):
        thought, x, detach_at, limit = carry
        thought = jnp.where(
            i == detach_at, jax.lax.stop_gradient(thought), thought
        )
        h = thought
        if self.recall:
            h = jnp.concatenate([h, x], axis=-1)  # NHWC channel concat
            h = Conv(self.num_filters, hex=self.hex, dtype=self.dtype)(h)
        for _b in range(self.num_blocks):
            h = BasicBlock(self.num_filters, hex=self.hex, dtype=self.dtype)(h)
        new = jnp.where(i < limit, h, thought)
        return (new, x, detach_at, limit), None


class RecurrentNet(nn.Module):
    policy_channels: int
    num_filters: int = 256
    num_blocks: int = 2
    recall: bool = True
    policy_head: str = "conv"
    value_head: str = "reduce"  # "reduce" | "dense"
    value_activation: str = "tanh"
    hex: bool = True
    dtype: jnp.dtype = jnp.float32

    recurrent: bool = True

    def __call__(
        self,
        x: jax.Array,
        iters_to_do: int = 2,
        interim_thought: Optional[jax.Array] = None,
        train: bool = False,  # no layer differs in training
        detach_at: Optional[jax.Array] = None,
        limit: Optional[jax.Array] = None,
    ):
        """Returns ((policy_logits, value), interim_thought).

        ``iters_to_do`` is static (scan length).  ``detach_at``/``limit``
        are optional *traced* scalars for the progressive loss; by default
        no detach happens and all iterations are active.
        """
        # (B, C, H, W) -> NHWC.
        x = jnp.transpose(x, (0, 2, 3, 1)).astype(self.dtype)
        initial_thought = nn.relu(
            Conv(self.num_filters, hex=self.hex, dtype=self.dtype)(x)
        )
        thought = initial_thought if interim_thought is None else interim_thought

        if detach_at is None:
            detach_at = jnp.int32(-1)
        if limit is None:
            limit = jnp.int32(iters_to_do)

        # One cell, named as the checkpoints name it; init creates its
        # parameters with one direct call, then the scan reuses them.
        cell = _RecurCell(
            self.num_filters, self.num_blocks, self.recall, self.hex,
            self.dtype, name="Scan_RecurCell_0",
        )
        carry = (thought, x, jnp.int32(detach_at), jnp.int32(limit))
        if nn.initializing():
            cell(carry, jnp.int32(0))
        (thought, _, _, _), _ = jax.lax.scan(
            cell, carry, jnp.arange(int(iters_to_do), dtype=jnp.int32)
        )

        if self.policy_head != "conv":
            raise ValueError(f"policy head {self.policy_head!r} unavailable")
        p = ReducePolicyHead(
            self.num_filters, self.policy_channels, hex=self.hex, dtype=self.dtype
        )(thought)

        # Full selector set incl. the reference's discontinued heads
        # (ref RecurrentNet.py:58-76).
        v = make_value_head(
            self.value_head,
            self.num_filters,
            activation=self.value_activation,
            hex=self.hex,
            dtype=self.dtype,
        )(thought)

        # Heads hand back f32 regardless of the compute dtype: losses,
        # mcts priors, and value targets all consume f32.
        return (p.astype(jnp.float32), v.astype(jnp.float32)), thought
