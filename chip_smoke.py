"""Bring-up check: the training path end to end on one GPU.

    python chip_smoke.py               # phases 1-6 on one card
    python chip_smoke.py --four-cards  # data-parallel training on 4 cards

One process drives the card(s).  Phases (each prints its own lines; any
failure raises and the script exits non-zero before the last line):

1. device     — JAX's first device must be a GPU; no CPU fallback.
2. engine     — fixed-seed random playouts of SCS (open_field_5, B=512) and
                Tic-Tac-Toe (B=4096) on the GPU and on the CPU, bit-exact
                on every state leaf, legal mask, player, terminal flag and
                value at every step.
3. hex conv   — ``hex_conv`` at real widths against the NumPy oracle, and
                the flagship RecurrentNet (256 filters, bf16, 4 iterations,
                B=512) against the same net in f32 on the CPU.
4. self-play  — move-batches at the bench shapes: invariants, steady-state
                time, compiled memory and peak device memory.
5. trainer    — ``AlphaZero.run`` with run.py's builders and the flagship
                configs for 3 steps, checkpoint written and restored.
6. last line  — ``{"ok": true, "device": {...}}``.

``--four-cards`` runs only the data-parallel path: ``AlphaZero.run`` on a
4-device ``dp`` mesh, and one learner gradient on 4 cards against 1 card.

Every line with a time carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", os.path.join(REPO, ".jax_cache"))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

#: Tolerances, as RMS of the error over RMS of the reference.
#: f32 under "highest": only the summation order differs.
TOL_F32_HIGHEST = 1e-5
#: f32 at default precision: the card may run convs in TF32 (10-bit
#: mantissa inputs, f32 accumulation), about 5e-4 expected.
TOL_TF32 = 1e-2
#: bf16 conv against the oracle on the same bf16-rounded inputs: with f32
#: accumulation the only error is the final rounding to bf16 (about 1e-3);
#: accumulating 1792 products in bf16 would exceed this.
TOL_BF16_CONV = 1e-2
#: bf16 network (inputs and every activation rounded to bf16 through 4
#: recurrent iterations) against the f32 network.
TOL_BF16_NET = 3e-2
#: Loss and gradients of one update, 4 cards against 1, f32 "highest": the
#: batch reduction is split across cards, so summation order differs.
TOL_DP_GRAD = 1e-4

#: Overrides of the flagship training config for the trainer phase; the
#: widths (512 actors, 100 simulations, 8 updates of 256) stay.
TRAINER_OVERRIDES = {
    "running.training_steps": 3,
    "saving.save_frequency": 3,
    "testing.early_testing": False,
    "testing.policy_test_frequency": 0,
    "testing.mcts_test_frequency": 0,
}
FOUR_CARD_STEPS = 2
OUT_DIR = os.path.join(REPO, "smoke_out")

CARD = ""


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def rel_rms(out, ref) -> float:
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((out - ref) ** 2) / np.mean(ref**2)))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# -- phase 2: engine on two devices --------------------------------------------


def engine_parity(env, batch: int, max_steps: int, dev_a, dev_b, seed: int = 0):
    """Play the same fixed-seed random games on ``dev_a`` and ``dev_b``;
    raise unless every state leaf, legal mask, current player, terminal
    flag and terminal value agree bit for bit at every step.  Returns the
    number of steps compared."""

    def read(state):
        return {
            "legal": jax.vmap(env.legal_mask)(state),
            "player": jax.vmap(env.current_player)(state),
            "terminal": jax.vmap(env.terminal)(state),
            "value": jax.vmap(env.terminal_value)(state),
        }

    def advance(state, action):
        done = jax.vmap(env.terminal)(state)
        stepped = jax.vmap(env.step)(state, action)
        state = jax.tree.map(
            lambda n, o: jnp.where(done.reshape(done.shape + (1,) * (n.ndim - 1)), o, n),
            stepped,
            state,
        )
        return state, read(state)

    init = jax.jit(lambda keys: (lambda s: (s, read(s)))(jax.vmap(env.init)(keys)))
    advance = jax.jit(advance)
    keys = jax.random.split(jax.random.key(seed), batch)
    rng = np.random.default_rng(seed)
    runs = [init(jax.device_put(keys, d)) for d in (dev_a, dev_b)]
    for t in range(max_steps + 1):
        (sa, ra), (sb, rb) = runs
        for name, x, y in [("state", sa, sb), ("read", ra, rb)]:
            for (path, la), lb in zip(
                jax.tree_util.tree_flatten_with_path(x)[0], jax.tree.leaves(y)
            ):
                check(
                    np.array_equal(np.asarray(la), np.asarray(lb)),
                    f"step {t}: {name}{jax.tree_util.keystr(path)} differs "
                    f"between {dev_a} and {dev_b}",
                )
        if t == max_steps or bool(np.asarray(ra["terminal"]).all()):
            return t
        legal = np.asarray(ra["legal"])
        scores = np.where(legal, rng.random(legal.shape), -1.0)
        action = scores.argmax(axis=1).astype(np.int32)
        runs = [
            advance(s, jax.device_put(action, d))
            for (s, _), d in zip(runs, (dev_a, dev_b))
        ]
    return max_steps


def phase_engine() -> None:
    from nuzero.envs import TicTacToe
    import run as cli

    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    for name, env, batch in [
        ("scs open_field_5", cli._scs_env("open_field_5.yml"), 512),
        ("ttt", TicTacToe(), 4096),
    ]:
        t0 = time.perf_counter()
        steps = engine_parity(env, batch, env.max_game_length, gpu, cpu)
        say(
            "engine",
            f"{name} B={batch}: {steps} steps bit-exact GPU vs CPU "
            f"({time.perf_counter() - t0:.1f}s incl. compile; {CARD})",
        )


# -- phase 3: hex conv and network at real widths --------------------------------


def hexconv_error(batch, size, cin, cout, dtype, precision_ctx, seed=0) -> float:
    """rel-RMS error of ``hex_conv`` (NHWC, as the networks call it) on
    the default device against the NumPy oracle on the same inputs."""
    from nuzero.ops.hexconv import hex_conv, hex_conv_reference

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, size, size, cin)).astype(np.float32)
    w = (rng.standard_normal((7, cin, cout)) / np.sqrt(7 * cin)).astype(np.float32)
    x = np.asarray(jnp.asarray(x, dtype).astype(jnp.float32))  # same rounding
    w = np.asarray(jnp.asarray(w, dtype).astype(jnp.float32))
    conv = jax.jit(lambda a, b: hex_conv(a, b, data_format="NHWC", precision=None))
    with precision_ctx():
        out = conv(jnp.asarray(x, dtype), jnp.asarray(w, dtype))
    out = np.asarray(out.astype(jnp.float32)).transpose(0, 3, 1, 2)
    ref = hex_conv_reference(x.transpose(0, 3, 1, 2), w)
    return rel_rms(out, ref)


def flagship_net(env, dtype):
    from nuzero.networks import NetworkManager, RecurrentNet

    net = RecurrentNet(
        policy_channels=env.action_space_shape[0],
        num_filters=256,
        num_blocks=2,
        hex=True,
        dtype=dtype,
    )
    return NetworkManager(net, env.observation_shape)


def phase_hexconv() -> None:
    import contextlib

    import run as cli

    highest = lambda: jax.default_matmul_precision("highest")  # noqa: E731
    cases = [
        ("B=768 5x5 256->256 bf16", (768, 5, 256, 256, jnp.bfloat16), contextlib.nullcontext, TOL_BF16_CONV),
        ("B=256 10x10 64->64 f32 highest", (256, 10, 64, 64, jnp.float32), highest, TOL_F32_HIGHEST),
        ("B=256 10x10 64->64 f32 default (TF32)", (256, 10, 64, 64, jnp.float32), contextlib.nullcontext, TOL_TF32),
    ]
    for name, args, ctx, tol in cases:
        err = hexconv_error(*args, ctx)
        say("hexconv", f"{name}: rel-RMS error {err:.3e} (tolerance {tol:.0e})")
        check(err <= tol, f"hex_conv {name}: error {err:.3e} > {tol:.0e}")

    env = cli._scs_env("open_field_5.yml")
    mgr16 = flagship_net(env, jnp.bfloat16)
    mgr32 = flagship_net(env, jnp.float32)
    variables = mgr16.init(jax.random.key(0))
    obs = (
        np.random.default_rng(1).random((512,) + env.observation_shape) < 0.3
    ).astype(np.float32)
    fwd16 = jax.jit(lambda v, o: mgr16.apply(v, o, iters_to_do=4)[:2])
    t0 = time.perf_counter()
    p16, v16 = jax.block_until_ready(fwd16(variables, jnp.asarray(obs)))
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(fwd16(variables, jnp.asarray(obs)))
    warm = time.perf_counter() - t0
    cpu = jax.devices("cpu")[0]
    fwd32 = jax.jit(lambda v, o: mgr32.apply(v, o, iters_to_do=4)[:2])
    with jax.default_matmul_precision("highest"):
        p32, v32 = fwd32(jax.device_put(variables, cpu), jax.device_put(obs, cpu))
    ep, ev = rel_rms(p16, p32), rel_rms(v16, v32)
    check(np.isfinite(np.asarray(p16)).all() and np.isfinite(np.asarray(v16)).all(),
          "flagship net output not finite")
    say(
        "hexconv",
        f"RecurrentNet 256f bf16 iters=4 B=512 vs f32 on CPU: policy rel-RMS "
        f"{ep:.3e}, value rel-RMS {ev:.3e} (tolerance {TOL_BF16_NET:.0e}); "
        f"forward {warm * 1e3:.2f} ms warm, {cold:.1f}s cold ({CARD})",
    )
    check(ep <= TOL_BF16_NET and ev <= TOL_BF16_NET, "bf16 network differs from f32")


# -- phase 4: self-play move-batches ---------------------------------------------


def selfplay_check(name, env, apply_fn, variables, batch, sims, steps) -> None:
    from nuzero.search import SearchParams
    from nuzero.search.mcts import make_search_fn
    from nuzero.training.selfplay import init_selfplay, make_selfplay_step

    params = SearchParams(num_simulations=sims)
    sp = init_selfplay(env, batch, jax.random.key(1), search_params=params)
    t0 = time.perf_counter()
    step = (
        jax.jit(make_selfplay_step(env, apply_fn, params), donate_argnums=(1,))
        .lower(variables, sp)
        .compile()
    )
    compile_s = time.perf_counter() - t0
    mem = step.memory_analysis()
    sp, _, _ = step(variables, sp)

    search = jax.jit(make_search_fn(env, apply_fn, params, training=True))
    res = search(variables, sp.games, sp.move_count, jax.random.key(2))
    legal = np.asarray(jax.vmap(env.legal_mask)(sp.games))
    action = np.asarray(res.action)
    visits = np.asarray(res.root_visits)
    check((visits == sims).all(), f"{name}: root visits {np.unique(visits)} != {sims}")
    check(legal[np.arange(batch), action].all(), f"{name}: an illegal action was chosen")

    moves = int(sp.total_moves)
    sp = jax.block_until_ready(sp)
    t0 = time.perf_counter()
    for _ in range(steps):
        sp, _, _ = step(variables, sp)
    sp = jax.block_until_ready(sp)
    dt = (time.perf_counter() - t0) / steps
    check(int(sp.total_moves) - moves == steps * batch, f"{name}: total_moves off")
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use", -1)
    say(
        "selfplay",
        f"{name} B={batch} sims={sims}: {dt * 1e3:.1f} ms/move-batch "
        f"({batch * sims / dt:.0f} sims/s) over {steps} steps, compile "
        f"{compile_s:.1f}s; memory_analysis: temp "
        f"{mem.temp_size_in_bytes / 2**30:.2f} GiB, args "
        f"{mem.argument_size_in_bytes / 2**30:.2f} GiB, out "
        f"{mem.output_size_in_bytes / 2**30:.2f} GiB; peak_bytes_in_use "
        f"{peak / 2**30:.2f} GiB ({CARD})",
    )


def phase_selfplay() -> None:
    from nuzero.envs import TicTacToe
    from nuzero.networks import MLPNetwork, NetworkManager
    import run as cli

    scs = cli._scs_env("open_field_5.yml")
    for filters, dtype, batch in [(64, "float32", 512), (256, "bfloat16", 768)]:
        mgr = cli._managers(scs, "recurrent", filters=filters, net_dtype=dtype)
        apply_fn = lambda v, o, m=mgr: m.apply(v, o, iters_to_do=2)[:2]  # noqa: E731
        selfplay_check(
            f"scs {filters}f {dtype}", scs, apply_fn,
            mgr.init(jax.random.key(0)), batch, 30, 5,
        )
    ttt = TicTacToe()
    mgr = NetworkManager(MLPNetwork(out_features=9), ttt.observation_shape)
    selfplay_check(
        "ttt mlp", ttt, lambda v, o: mgr.apply(v, o)[:2],
        mgr.init(jax.random.key(0)), 4096, 100, 5,
    )


# -- phase 5: the trainer ----------------------------------------------------------


def flagship_setup(overrides: dict):
    """run.py's builders and the flagship configs, with ``overrides``
    (``"section.field": value``) applied."""
    import run as cli
    from nuzero.config import load_search_config, load_training_config

    env = cli._scs_env("open_field_5.yml")
    mgr = cli._managers(env, "recurrent", filters=256, net_dtype="bfloat16")
    cfg = load_training_config(
        os.path.join(REPO, "configs", "training", "scs_contested256.yaml")
    )
    search = load_search_config(
        os.path.join(REPO, "configs", "search", "scs_contested256_search.yaml")
    )
    for key, value in overrides.items():
        section, field = key.split(".")
        sub = dataclasses.replace(getattr(cfg, section), **{field: value})
        cfg = dataclasses.replace(cfg, **{section: sub})
    return env, mgr, cfg, search


def phase_trainer() -> None:
    from nuzero.training import AlphaZero
    from nuzero.utils.checkpoint import restore_checkpoint

    env, mgr, cfg, search = flagship_setup(TRAINER_OVERRIDES)
    say("trainer", f"scs_contested256 configs with overrides {TRAINER_OVERRIDES}")
    run_dir = os.path.join(OUT_DIR, "scs_contested256")
    shutil.rmtree(run_dir, ignore_errors=True)
    az = AlphaZero(env, mgr, cfg, search, run_dir=run_dir)
    state0 = az.learner.init_state(jax.random.key(0))
    params0 = jax.device_get(state0.params)
    t0 = time.perf_counter()
    state = jax.block_until_ready(az.run(initial_state=state0))
    total = time.perf_counter() - t0

    records = [r for r in az.journal.load() if "loss/combined" in r]
    check(len(records) == cfg.running.training_steps, f"journal has {len(records)} steps")
    for r in records:
        check(np.isfinite(r["loss/combined"]), f"step {r['step']}: loss not finite")
        say(
            "trainer",
            f"step {r['step']}: loss {r['loss/combined']:.4f}, "
            f"{r['step_time_s']:.2f}s ({CARD})",
        )
    params = jax.device_get(state.params)
    changed = [
        not np.array_equal(a, b)
        for a, b in zip(jax.tree.leaves(params0), jax.tree.leaves(params))
    ]
    check(all(changed), f"{changed.count(False)} parameter leaves did not change")
    games = int(az.buffer.num_games)
    check(games > 0, "replay buffer holds no finished games")
    restored, step = restore_checkpoint(
        os.path.join(run_dir, "checkpoints"), "auto", {"params": state.params}
    )
    same = all(
        np.array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(jax.tree.leaves(restored["params"]), jax.tree.leaves(params))
    )
    check(step == cfg.running.training_steps and same, "checkpoint does not restore")
    say(
        "trainer",
        f"{len(records)} steps in {total:.1f}s incl. early fill and compile; "
        f"{games} games in the buffer; parameters changed; checkpoint at step "
        f"{step} restores bit-exact ({CARD})",
    )


# -- --four-cards: data parallelism --------------------------------------------------


def random_batch(env, batch: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    obs = (rng.random((batch,) + env.observation_shape) < 0.3).astype(np.float32)
    logits = rng.standard_normal((batch, env.num_actions)).astype(np.float32)
    policy = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    value = rng.uniform(-1, 1, batch).astype(np.float32)
    return obs, policy, value


def dp_gradient_error(learner, env, batch: int, one_device, mesh_devices) -> tuple:
    """Loss and gradients of one learner update on a fixed batch, placed
    on ``one_device`` and sharded over a ``dp`` mesh of ``mesh_devices``,
    under "highest" precision.  Returns (loss rel error, worst gradient
    leaf rel-RMS error)."""
    from nuzero.parallel import make_mesh
    from nuzero.parallel.mesh import place_batch_sharded, place_replicated

    params = jax.device_get(learner.manager.init(jax.random.key(0)))
    data = random_batch(env, batch)
    rng = jax.random.key(3)
    grad = jax.jit(jax.value_and_grad(learner._forward_loss, has_aux=True))
    mesh = make_mesh(list(mesh_devices))
    with jax.default_matmul_precision("highest"):
        (l1, _), g1 = grad(
            jax.device_put(params, one_device),
            *jax.device_put(data, one_device),
            jax.device_put(rng, one_device),
        )
        (l4, _), g4 = grad(
            place_replicated(params, mesh),
            *place_batch_sharded(data, mesh),
            place_replicated(rng, mesh),
        )
    loss_err = abs(float(l1) - float(l4)) / abs(float(l1))
    grad_err = max(
        rel_rms(a, b) for a, b in zip(jax.tree.leaves(g1), jax.tree.leaves(g4))
    )
    return loss_err, grad_err


def four_cards() -> None:
    from nuzero.networks import NetworkManager
    from nuzero.parallel import make_mesh, shard_batch
    from nuzero.training import AlphaZero
    from nuzero.training.learner import Learner
    from nuzero.training.pipeline import learner_config_from_training

    devices = jax.devices()[:4]
    env, mgr, cfg, search = flagship_setup(
        {**TRAINER_OVERRIDES, "running.training_steps": FOUR_CARD_STEPS}
    )
    mesh = make_mesh(devices)
    run_dir = os.path.join(OUT_DIR, "scs_contested256_dp4")
    shutil.rmtree(run_dir, ignore_errors=True)
    az = AlphaZero(env, mgr, cfg, search, run_dir=run_dir, mesh=mesh)
    t0 = time.perf_counter()
    state = jax.block_until_ready(az.run(seed=0))
    total = time.perf_counter() - t0
    for leaf in jax.tree.leaves(state.params):
        shards = [np.asarray(s.data) for s in leaf.addressable_shards]
        check(len(shards) == 4, f"params on {len(shards)} devices, not 4")
        check(all(np.array_equal(shards[0], s) for s in shards[1:]),
              "params differ between devices")
    states = az.buffer.states
    check(states.sharding.is_equivalent_to(shard_batch(mesh), states.ndim),
          "replay game axis is not sharded over the mesh")
    steps = [r for r in az.journal.load() if "loss/combined" in r]
    for r in steps:
        check(np.isfinite(r["loss/combined"]), f"step {r['step']}: loss not finite")
        say("four-cards", f"step {r['step']}: loss {r['loss/combined']:.4f}, "
            f"{r['step_time_s']:.2f}s ({CARD})")
    say(
        "four-cards",
        f"AlphaZero.run on a 4-card dp mesh: {FOUR_CARD_STEPS} steps in "
        f"{total:.1f}s incl. early fill and compile; params bit-identical on "
        f"4 cards; replay game axis sharded; {int(az.buffer.num_games)} games "
        f"({CARD})",
    )

    f32 = NetworkManager(
        dataclasses.replace(mgr.module, dtype=jnp.float32), mgr.observation_shape
    )
    learner = Learner(f32, learner_config_from_training(cfg))
    batch = cfg.learning.batch_size
    loss_err, grad_err = dp_gradient_error(learner, env, batch, devices[0], devices)
    say(
        "four-cards",
        f"learner gradient, 256f f32 'highest', B={batch}, 4 cards vs 1: loss "
        f"rel error {loss_err:.3e}, worst gradient rel-RMS {grad_err:.3e} "
        f"(tolerance {TOL_DP_GRAD:.0e})",
    )
    check(loss_err <= TOL_DP_GRAD and grad_err <= TOL_DP_GRAD,
          "4-card gradient differs from 1-card")


def main() -> None:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card data-parallel path")
    args = ap.parse_args()

    from nuzero.utils.device import card_line, require_gpu

    cards = 4 if args.four_cards else 1
    dev = require_gpu(cards)
    CARD = card_line()
    print(f"card: {CARD}", flush=True)
    say("device", f"{dev['platform']} {dev['kind']} x{dev['count']}")
    if args.four_cards:
        four_cards()
    else:
        phase_engine()
        phase_hexconv()
        phase_selfplay()
        phase_trainer()
    print(json.dumps({"ok": True, "device": dev}), flush=True)


if __name__ == "__main__":
    main()
