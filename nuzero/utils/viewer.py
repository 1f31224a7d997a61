"""Pygame board viewer for SCS (host-side, off the compute path).

Parity target: the reference's ``Games/SCS/SCS_Renderer.py`` — hexagon board
drawing (ref ``:255-442``), interactive analysis replay with arrow keys (ref
``analyse``, ``:105-219``), live mode polling a shared store for snapshots
(ref ``render``, ``:51-102``), and NATO-style unit-counter image generation
(ref ``create_counter_from_scratch``/``add_border``, ``:467-609``).

Design differences from the reference (deliberate): the viewer reads the
engine's packed array state (``SCSState``) instead of Tile/Unit objects, the
live mode polls any ``poll_fn() -> state`` callable instead of a Ray
RemoteStorage actor, and everything runs headless under
``SDL_VIDEODRIVER=dummy`` for tests/CI.

pygame is imported lazily so the compute path never depends on SDL.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Optional, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# palette

_BG = (24, 26, 30)
_GRID = (60, 64, 70)
_TEXT = (230, 230, 230)
_PLAYER = ((66, 135, 245), (235, 64, 52))  # p0 blue, p1 red
_VP_RING = (255, 215, 0)


def _terrain_color(attack_mod: float, defense_mod: float, cost: float):
    """Map terrain stats to a color: flat ground green, costly ground
    darker/bluer (marsh), defensive ground grey (ridge), attack bonus
    warm (grove)."""
    base = np.array([106, 140, 92], float)  # field green
    if cost > 1 and defense_mod > 1:
        base = np.array([120, 120, 128], float)  # ridge grey
    elif cost > 1:
        base = np.array([82, 104, 118], float)  # marsh blue-grey
    elif attack_mod > 1:
        base = np.array([146, 124, 72], float)  # grove ochre
    return tuple(int(x) for x in base)


def _ensure_pygame():
    if "DISPLAY" not in os.environ and "SDL_VIDEODRIVER" not in os.environ:
        os.environ["SDL_VIDEODRIVER"] = "dummy"
    import pygame

    if not pygame.get_init():
        pygame.init()
    return pygame


def _hex_corners(cx: float, cy: float, s: float):
    """Flat-top hexagon corner ring."""
    return [
        (cx + s * math.cos(math.radians(60 * i)),
         cy + s * math.sin(math.radians(60 * i)))
        for i in range(6)
    ]


def _hex_center(r: int, c: int, s: float, margin: float):
    """Offset coordinates -> pixels. Odd columns shift DOWN half a hex
    (matches the neighbor tables in ``envs/scs/hexgrid.py``: from even c,
    ne = (r-1, c+1))."""
    h = math.sqrt(3.0) * s
    cx = margin + s + c * 1.5 * s
    cy = margin + h / 2 + r * h + (h / 2 if c % 2 else 0.0)
    return cx, cy


def board_pixel_size(rows: int, cols: int, s: float, margin: float):
    h = math.sqrt(3.0) * s
    w = int(2 * margin + 1.5 * s * (cols - 1) + 2 * s) + 1
    ht = int(2 * margin + rows * h + h / 2) + 1
    return w, ht + 28  # HUD strip


def draw_counter(surface, rect, attack, defense, movement, player, *, status=0):
    """NATO-style unit counter onto ``rect`` of ``surface``
    (ref counter drawing, ``SCS_Renderer.py:467-560``)."""
    import pygame

    color = _PLAYER[player]
    if status == 1:  # moved
        color = tuple(int(x * 0.75) for x in color)
    elif status == 2:  # attacked
        color = tuple(int(x * 0.5) for x in color)
    pygame.draw.rect(surface, color, rect, border_radius=3)
    pygame.draw.rect(surface, (20, 20, 20), rect, width=2, border_radius=3)
    # infantry crossed-box symbol
    box = rect.inflate(-rect.w * 0.35, -rect.h * 0.55)
    box.centery = rect.centery - rect.h * 0.12
    pygame.draw.rect(surface, (20, 20, 20), box, width=2)
    pygame.draw.line(surface, (20, 20, 20), box.topleft, box.bottomright, 2)
    pygame.draw.line(surface, (20, 20, 20), box.bottomleft, box.topright, 2)
    font = pygame.font.Font(None, max(12, int(rect.h * 0.42)))
    txt = font.render(f"{int(attack)}-{int(defense)}-{int(movement)}", True, (15, 15, 15))
    surface.blit(
        txt, (rect.centerx - txt.get_width() / 2, rect.bottom - txt.get_height() - 2)
    )


def create_counter(
    path: str, attack: int, defense: int, movement: int, player: int, size: int = 128
) -> str:
    """Standalone counter PNG (ref ``create_counter_from_scratch`` writes
    unit images on scenario load, ``SCS_Game.py:1795-1828``)."""
    pygame = _ensure_pygame()
    surf = pygame.Surface((size, size))
    surf.fill((250, 250, 250))
    draw_counter(
        surf, pygame.Rect(4, 4, size - 8, size - 8), attack, defense, movement, player
    )
    pygame.image.save(surf, path)
    return path


_STAGE_NAMES = {
    -2: "P0 placement",
    -1: "P1 placement",
    0: "P0 reinforce",
    1: "P0 move",
    2: "P0 choose target",
    3: "P0 choose attackers",
    4: "P1 reinforce",
    5: "P1 move",
    6: "P1 choose target",
    7: "P1 choose attackers",
}


class SCSViewer:
    """Render packed SCS states. ``env`` is an ``SCSGame``."""

    def __init__(self, env, hex_size: float = 34.0, margin: float = 12.0):
        self.env = env
        self.s = hex_size
        self.margin = margin
        self.pygame = _ensure_pygame()
        self.size = board_pixel_size(env.R, env.C, hex_size, margin)

    # -- drawing -----------------------------------------------------------

    def frame(self, state):
        """Draw one state to a new Surface."""
        pygame = self.pygame
        env = self.env
        surf = pygame.Surface(self.size)
        surf.fill(_BG)

        t_att = np.asarray(env.t_attack)
        t_def = np.asarray(env.t_defense)
        t_cost = np.asarray(env.t_cost)
        vp = np.asarray(env.vp)
        board = np.asarray(state.board)
        status = np.asarray(state.status)
        S = env.S

        for r in range(env.R):
            for c in range(env.C):
                cx, cy = _hex_center(r, c, self.s, self.margin)
                corners = _hex_corners(cx, cy, self.s)
                pygame.draw.polygon(
                    surf, _terrain_color(t_att[r, c], t_def[r, c], t_cost[r, c]), corners
                )
                pygame.draw.polygon(surf, _GRID, corners, width=2)
                for p in (0, 1):
                    if vp[p, r, c]:
                        pygame.draw.circle(surf, _VP_RING, (cx, cy), self.s * 0.62, width=3)
                        pygame.draw.circle(surf, _PLAYER[p], (cx, cy), self.s * 0.18)
                # counters bottom-up with a small stack offset
                for k in range(board.shape[2]):
                    uid = int(board[r, c, k])
                    if uid < 0:
                        continue
                    p = uid // S
                    w = self.s * 1.05
                    rect = pygame.Rect(0, 0, w, w * 0.78)
                    rect.center = (cx + k * 4, cy - k * 5)
                    draw_counter(
                        surf,
                        rect,
                        float(np.asarray(env.u_attack)[uid]),
                        float(np.asarray(env.u_defense)[uid]),
                        float(np.asarray(env.u_allowance)[uid]),
                        p,
                        status=int(status[uid]),
                    )
        # target-tile highlight during fighting stages
        if bool(np.asarray(state.has_target)):
            tr, tc = int(state.target_row), int(state.target_col)
            cx, cy = _hex_center(tr, tc, self.s, self.margin)
            pygame.draw.polygon(
                surf, (255, 80, 80), _hex_corners(cx, cy, self.s), width=4
            )
        # HUD
        font = pygame.font.Font(None, 22)
        stage = int(np.asarray(state.stage))
        hud = (
            f"turn {int(np.asarray(state.turn))}/{env.scenario.turns}   "
            f"{_STAGE_NAMES.get(stage, stage)}   move {int(np.asarray(state.length))}"
        )
        if bool(np.asarray(state.terminal)):
            hud += f"   TERMINAL value={float(np.asarray(state.terminal_value)):+.1f}"
        surf.blit(font.render(hud, True, _TEXT), (8, self.size[1] - 22))
        return surf

    def save_png(self, state, path: str) -> str:
        self.pygame.image.save(self.frame(state), path)
        return path

    # -- interactive modes ---------------------------------------------------

    def _replay_states(self, actions: Sequence[int]):
        import jax

        step = jax.jit(self.env.step)
        states = [self.env.init(None)]
        for a in actions:
            states.append(step(states[-1], int(a)))
        return states

    def analyse(self, actions: Sequence[int], fps: int = 30,
                auto: bool = False):
        """Replay an action history; left/right arrows step, Down prints the
        state tensor, Up prints the legal mask, Esc/close quits (ref
        ``analyse``, ``SCS_Renderer.py:105-219``).  ``auto`` steps through
        every state once and exits — the non-interactive (CI/headless)
        mode."""
        pygame = self.pygame
        states = self._replay_states(actions)
        screen = pygame.display.set_mode(self.size)
        pygame.display.set_caption("nuzero SCS analysis")
        clock = pygame.time.Clock()
        i, running = 0, True
        while running:
            for ev in pygame.event.get():
                if ev.type == pygame.QUIT:
                    running = False
                elif ev.type == pygame.KEYDOWN:
                    if ev.key == pygame.K_ESCAPE:
                        running = False
                    elif ev.key == pygame.K_RIGHT:
                        i = min(i + 1, len(states) - 1)
                    elif ev.key == pygame.K_LEFT:
                        i = max(i - 1, 0)
                    elif ev.key == pygame.K_DOWN:
                        print(np.asarray(self.env.observe(states[i])))
                    elif ev.key == pygame.K_UP:
                        print(np.flatnonzero(np.asarray(self.env.legal_mask(states[i]))))
            screen.blit(self.frame(states[i]), (0, 0))
            pygame.display.flip()
            if auto:
                if i >= len(states) - 1:
                    running = False
                i += 1
            clock.tick(fps)
        pygame.display.quit()

    def live(self, poll_fn: Callable[[], Optional[object]], fps: int = 4,
             stop_fn: Optional[Callable[[], bool]] = None):
        """Live mode: redraw whatever ``poll_fn`` returns until it yields a
        terminal state or ``stop_fn`` fires (ref ``render`` polling loop,
        ``SCS_Renderer.py:51-102``)."""
        pygame = self.pygame
        screen = pygame.display.set_mode(self.size)
        pygame.display.set_caption("nuzero SCS live")
        clock = pygame.time.Clock()
        running = True
        while running:
            for ev in pygame.event.get():
                if ev.type == pygame.QUIT or (
                    ev.type == pygame.KEYDOWN and ev.key == pygame.K_ESCAPE
                ):
                    running = False
            state = poll_fn()
            if state is not None:
                screen.blit(self.frame(state), (0, 0))
                pygame.display.flip()
                if bool(np.asarray(state.terminal)):
                    running = False
            if stop_fn is not None and stop_fn():
                running = False
            clock.tick(fps)
        pygame.display.quit()
