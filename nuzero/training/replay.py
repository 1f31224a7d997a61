"""Device-resident replay buffer with game-count windowing.

Behavioral target: ``Training/ReplayBuffer.py`` — a FIFO of positions whose
window is counted in *games*, not positions (ref ``ReplayBuffer.py:24-36``),
with uniform or late-heavy (recency-weighted) sampling
(ref ``Training/AlphaZero.py:779-792``).

Design: instead of a Ray actor holding Python tuples, the buffer
is a pytree of fixed-shape device arrays organized as a *ring of game
slots*: ``[capacity_games, max_game_length, ...]``.  Finished games arrive
as whole batches from the lockstep self-play engine and are scattered into
ring slots in one ``.at[].set``; sampling flattens (slot, position) into one
categorical draw.  Everything jits; the buffer lives in device memory and
can be sharded over devices on its game axis.

Positions are stored as PACKED ENV STATES (``utils.packing`` f32 vectors),
not observation tensors: the SCS observation is ~11x larger than the state
that generates it (f32[1024, 622, 2150] = 5.5 GB of observations for one
5x5 scenario at B=1024, by shape arithmetic).  Samplers regenerate
observations from the sampled positions only (``env.observe`` on a few
thousand states per update) — recompute over store: device memory
capacity and bandwidth are the scarce resource, `observe` is a handful of
gathers.  (The reference stores full state tensors per position,
``ReplayBuffer.py:24-36`` — fine for host RAM, wrong for device memory.)

Value targets are the game's static terminal value broadcast over its
positions (ref ``tic_tac_toe.py:184-190`` ``make_target`` — no per-player
sign flip).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from nuzero.utils import struct


@struct.dataclass
class FinishedGames:
    """A batch of completed games emitted by one self-play step."""

    states: jax.Array  # f32[B, L, D] packed env states (utils.packing)
    policy: jax.Array  # f32[B, L, A]
    final_value: jax.Array  # f32[B] static terminal value
    length: jax.Array  # i32[B] positions recorded
    game_type: jax.Array  # i32[B]
    mask: jax.Array  # bool[B] True where the row is a real finished game


@struct.dataclass
class ReplayBuffer:
    states: jax.Array  # f32[G, L, D] packed env states
    policy: jax.Array  # f32[G, L, A]
    value: jax.Array  # f32[G, L]
    length: jax.Array  # i32[G] 0 = empty slot
    game_type: jax.Array  # i32[G]
    seq: jax.Array  # i32[G] insertion sequence number (-1 = empty)
    ptr: jax.Array  # i32 next ring slot
    games_added: jax.Array  # i32 total games ever added

    @property
    def capacity(self) -> int:
        return self.length.shape[0]

    @property
    def num_games(self) -> jax.Array:
        return jnp.minimum(self.games_added, self.length.shape[0])

    @property
    def num_positions(self) -> jax.Array:
        return self.length.sum()


def create_buffer(
    capacity_games: int,
    max_game_length: int,
    state_dim: int,
    num_actions: int,
) -> ReplayBuffer:
    """``state_dim``: width of the packed-state vectors (the max across
    game types when several envs share the buffer)."""
    G, L = capacity_games, max_game_length
    return ReplayBuffer(
        states=jnp.zeros((G, L, state_dim), jnp.float32),
        policy=jnp.zeros((G, L, num_actions), jnp.float32),
        value=jnp.zeros((G, L), jnp.float32),
        length=jnp.zeros(G, jnp.int32),
        game_type=jnp.zeros(G, jnp.int32),
        seq=jnp.full(G, -1, jnp.int32),
        ptr=jnp.int32(0),
        games_added=jnp.int32(0),
    )


def add_games(buffer: ReplayBuffer, finished: FinishedGames) -> ReplayBuffer:
    """Scatter a batch of finished games into the ring (jit-friendly).

    Masked-out rows are routed to an out-of-bounds slot index and dropped
    by XLA's scatter ``mode='drop'`` — no host round-trip.
    """
    G = buffer.capacity
    m = finished.mask
    offset = jnp.cumsum(m.astype(jnp.int32)) - 1  # rank among real games
    slot = (buffer.ptr + offset) % G
    slot = jnp.where(m, slot, G)  # OOB -> dropped
    seq = jnp.where(m, buffer.games_added + offset, 0)

    L = buffer.states.shape[1]
    pos_valid = (
        jnp.arange(L)[None, :] < finished.length[:, None]
    )  # bool[B, L]
    value = jnp.where(pos_valid, finished.final_value[:, None], 0.0)

    n_new = m.sum().astype(jnp.int32)
    return buffer.replace(
        states=buffer.states.at[slot].set(finished.states, mode="drop"),
        policy=buffer.policy.at[slot].set(finished.policy, mode="drop"),
        value=buffer.value.at[slot].set(value, mode="drop"),
        length=buffer.length.at[slot].set(finished.length, mode="drop"),
        game_type=buffer.game_type.at[slot].set(finished.game_type, mode="drop"),
        seq=buffer.seq.at[slot].set(seq, mode="drop"),
        ptr=(buffer.ptr + n_new) % G,
        games_added=buffer.games_added + n_new,
    )


def truncate_to_seq(buffer: ReplayBuffer, seq_limit) -> ReplayBuffer:
    """Restore the buffer to its state just before insertion ``seq_limit``
    (ref ``ReplayBuffer.py:64-104``: ``step_to_size_map`` partial load —
    resume at an earlier training step samples only games that existed
    then).

    Games inserted at/after ``seq_limit`` are dropped.  Like the reference
    (which only allows partial loading "until the window first overflows"),
    games older than the window that were already overwritten by dropped
    ones cannot be recovered; their slots stay empty.  ``games_added`` is
    reset to ``seq_limit`` (the true insertion count at that point), so the
    late-heavy recency ranks are computed as they were then.
    """
    seq_limit = jnp.int32(seq_limit)
    keep = (buffer.seq >= 0) & (buffer.seq < seq_limit)
    return buffer.replace(
        length=jnp.where(keep, buffer.length, 0),
        seq=jnp.where(keep, buffer.seq, -1),
        game_type=jnp.where(keep, buffer.game_type, 0),
        games_added=jnp.minimum(buffer.games_added, seq_limit),
        ptr=seq_limit % buffer.capacity,
    )


def position_weights(buffer: ReplayBuffer, late_heavy: bool) -> jax.Array:
    """f32[G, L] unnormalized sampling weights over valid positions.

    ``late_heavy`` reproduces the reference's linear recency ramp
    (``AlphaZero.py:779-792``): weight = offset + variation * rank, with
    rank the position's age order.  The reference ranks individual
    positions; here the rank is the game's normalized insertion order
    (positions within a game share a weight) — identical in distribution
    up to within-game ordering.
    """
    G, L = buffer.value.shape
    valid = jnp.arange(L)[None, :] < buffer.length[:, None]
    if not late_heavy:
        return valid.astype(jnp.float32)
    num = jnp.maximum(buffer.num_games, 1).astype(jnp.float32)
    oldest = buffer.games_added - buffer.num_games  # seq of oldest retained
    rank = (buffer.seq - oldest + 1).astype(jnp.float32) / num  # (0, 1]
    variation = 0.5
    w = (1.0 - variation) / 2.0 + variation * rank
    return jnp.where(valid, w[:, None], 0.0)


def epoch_permutation(buffer: ReplayBuffer, rng: jax.Array, game_type=None):
    """i32[G*L] flat position indices with every VALID position first, in
    uniform-random order (invalid slots follow).

    The device analogue of the reference's per-epoch buffer shuffle
    (``ReplayBuffer.shuffle`` + slice sweep, ``AlphaZero.py:713-737``):
    slicing the first ``n_batches * batch_size`` entries visits each valid
    position at most once per epoch.  ``game_type`` restricts validity to
    one type's positions.
    """
    G, L = buffer.value.shape
    valid = jnp.arange(L)[None, :] < buffer.length[:, None]
    if game_type is not None:
        valid = valid & (buffer.game_type == game_type)[:, None]
    valid = valid.reshape(-1)
    # Random sort key; +2 pushes invalid slots after every valid one.
    key = jax.random.uniform(rng, valid.shape) + jnp.where(valid, 0.0, 2.0)
    return jnp.argsort(key).astype(jnp.int32)


def gather(buffer: ReplayBuffer, flat_idx: jax.Array):
    """Fetch positions by flat (game, position) index — the epoch sweep's
    batch extraction.  Returns (states, policy, value, game_type)."""
    G, L = buffer.value.shape
    gi, pi = flat_idx // L, flat_idx % L
    return (
        buffer.states[gi, pi],
        buffer.policy[gi, pi],
        buffer.value[gi, pi],
        buffer.game_type[gi],
    )


def sample(
    buffer: ReplayBuffer,
    rng: jax.Array,
    batch_size: int,
    *,
    late_heavy: bool = False,
    with_replacement: bool = True,
    game_type=None,
):
    """Draw a training batch of positions.

    Returns (states [B, D] packed, policy [B, A], value [B],
    game_type [B]).  The caller materializes observations from the packed
    states (``env.observe`` over the unpacked batch) — see the module
    docstring for why observations are not stored.
    Without replacement uses Gumbel top-k over the flat weight table.
    ``game_type`` restricts the draw to one game type's positions (the
    reference buckets recurrent batches by game index,
    ``AlphaZero.py:846-870``; here each type gets its own sub-batch).
    """
    G, L = buffer.value.shape
    w = position_weights(buffer, late_heavy)
    if game_type is not None:
        w = w * (buffer.game_type == game_type)[:, None]
    w = w.reshape(-1)
    logw = jnp.where(w > 0, jnp.log(jnp.maximum(w, 1e-30)), -jnp.inf)
    if with_replacement:
        flat = jax.random.categorical(rng, logw, shape=(batch_size,))
    else:
        g = jax.random.gumbel(rng, logw.shape)
        _, flat = jax.lax.top_k(logw + g, batch_size)
    gi, pi = flat // L, flat % L
    return (
        buffer.states[gi, pi],
        buffer.policy[gi, pi],
        buffer.value[gi, pi],
        buffer.game_type[gi],
    )
