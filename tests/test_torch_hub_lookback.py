"""The single-pass ``hub_route`` kernel's protocol, rebuilt on the CPU.

``csrc/hub_route.cu`` runs only on the card.  Its order of operations is
rebuilt here in plain Python over torch's int32 inputs (in this file
only) and held, bit for bit, against the port's plain version
(``hub_route_plain``), the JAX package's Pallas kernel in interpret mode
and both sequential oracles (``repro.core.engine_jax.hub_visibility_ref``
and the port's copy):

- tiles of ``tile`` messages take tickets in order; each scans its
  messages on chip and publishes, in a scratch that outlives the call,
  a flag (epoch, G, status) and an (S, A) payload: its inclusive prefix
  at once (INC) for tile 0 or an aggregate with G set, else its
  aggregate (AGG);
- a tile whose first message does not start a segment looks back over
  its predecessors in windows of 32, nearest first, each lane waiting
  until its tile's flag carries this call's epoch; the window stops at
  the nearest INC or aggregate with G, and folds lanes ``last .. 0`` in
  order, as the kernel's shuffle-down suffix scan does;
- it then publishes INC and writes S + A + lat[link];
- the last tile to finish resets the ticket and done counters and
  advances the epoch.

Tiles run under a random interleaving of their steps (seeded), so a
look-back meets predecessors that have published only their aggregate,
or nothing yet in this call: a stale flag of an earlier call, which it
must wait out.  Tiles of 1, 7 and ``hub_route.TILE`` messages; M = 1, 7,
129, TILE +- 1 and more; one link for every message (the longest
look-back), one message a link, and a few links.  Every result is
integer, so every comparison is bit-equal.
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine_jax import hub_visibility_ref
from repro.kernels.hub_route import hub_route as jax_hub_route
from repro_torch.kernels import hub_route as kmod
from repro_torch.kernels import ref as tref

NEG = -(2**30)
ID = (NEG, 0, 0)
AGG, INC = 1, 2
TILE = kmod.TILE


def combine(x, y):
    """x earlier, y later: the kernel's combine of (S, A, G)."""
    if y[2]:
        return (y[0], y[1], 1)
    return (max(x[0], y[0] - x[1]), x[1] + y[1], x[2] | y[2])


class Scratch:
    """The kernel's scratch: header {ticket, done, epoch} and per tile a
    flag (epoch, G, status) and the AGG and INC payloads, zero-filled
    once and kept across calls."""

    def __init__(self, cap):
        self.cap = cap
        self.ticket = self.done = self.epoch = 0
        self.flags = [(0, 0, 0)] * cap
        self.agg = [(0, 0)] * cap
        self.inc = [(0, 0)] * cap


def tile_steps(sc, stats, tile_no, tiles, elems, lat_of, out, lo,
               early_inc):
    """One block's work as a generator: it yields wherever another block
    may run in between (after each publication and at each poll)."""
    epoch = sc.epoch
    total = ID
    for e in elems:
        total = combine(total, e)
    early = tile_no == 0 or (early_inc and total[2])
    if early:
        sc.inc[tile_no] = total[:2]
        sc.flags[tile_no] = (epoch, total[2], INC)
    else:
        sc.agg[tile_no] = total[:2]
        sc.flags[tile_no] = (epoch, total[2], AGG)
    yield
    prefix = ID
    if tile_no > 0 and not elems[0][2]:
        acc = ID
        j0 = tile_no - 1
        while True:
            lanes = []
            for lane in range(32):
                j = j0 - lane
                if j < 0:
                    lanes.append((ID, False, False))
                    continue
                while True:                     # the lane's poll
                    ep, g, st = sc.flags[j]
                    if st != 0 and ep == epoch:
                        break
                    stats["stale_waits" if st else "empty_waits"] += 1
                    yield
                s, a = sc.inc[j] if st == INC else sc.agg[j]
                lanes.append(((s, a, g), st == INC or bool(g), st == INC))
            stops = [i for i, lane_ in enumerate(lanes) if lane_[1]]
            last = stops[0] if stops else 31
            window = ID
            for i in range(last, -1, -1):       # lanes last .. 0 in order
                window = combine(window, lanes[i][0])
            acc = combine(window, acc)
            stats["windows"] += 1
            if stops:
                stats["stop_inc" if lanes[last][2] else "stop_g"] += 1
                break
            j0 -= 32
        prefix = acc
    if not early:
        p = combine(prefix, total)
        sc.inc[tile_no] = p[:2]
        sc.flags[tile_no] = (epoch, p[2], INC)
    run = prefix
    for k, e in enumerate(elems):
        run = combine(run, e)
        out[lo + k] = run[0] + run[1] + lat_of[lo + k]
    sc.done += 1
    if sc.done == tiles:      # the last block to finish
        sc.ticket = sc.done = 0
        sc.epoch += 1


def lookback(send, ser, link, lat, tile, sc=None, seed=0, early_inc=True):
    """The kernel's arithmetic on one call: (out (M,) int32 tensor,
    stats).  ``sc`` is the scratch kept across calls (a fresh one holding
    the call's tiles when None)."""
    m = send.shape[0]
    tiles = -(-m // tile)
    if sc is None:
        sc = Scratch(tiles)
    assert tiles <= sc.cap
    s_, a_, l_ = send.tolist(), ser.tolist(), link.tolist()
    lat_l = lat.tolist()
    elems = [(s_[i], a_[i], int(i == 0 or l_[i] != l_[i - 1]))
             for i in range(m)]
    lat_of = [lat_l[x] for x in l_]
    out = [0] * m
    stats = dict(stale_waits=0, empty_waits=0, windows=0, stop_inc=0,
                 stop_g=0)
    rng = random.Random(seed)
    running = []
    started = 0
    while started < tiles or running:
        if started < tiles and (not running or rng.random() < 0.5):
            assert sc.ticket == started
            t = sc.ticket                        # ticket order
            sc.ticket += 1
            lo = t * tile
            running.append(tile_steps(sc, stats, t, tiles,
                                      elems[lo:lo + tile], lat_of, out, lo,
                                      early_inc))
            started += 1
            continue
        g = rng.choice(running)
        try:
            next(g)
        except StopIteration:
            running.remove(g)
    return torch.tensor(out, dtype=torch.int32), stats


def _msgs(m, kind, seed):
    rng = np.random.default_rng(seed)
    n_links = {"one_link": 1, "per_link": m, "few": 5}[kind]
    link = (np.arange(m) if kind == "per_link"
            else np.sort(rng.integers(0, n_links, m))).astype(np.int32)
    send = rng.integers(0, 1_000_000, m).astype(np.int32)
    order = np.lexsort((send, link))
    send, link = send[order], link[order]
    ser = rng.integers(0, 10_000, m).astype(np.int32)
    ser[rng.random(m) < 0.2] = 163
    lat = rng.integers(0, 5_000, n_links).astype(np.int32)
    return send, ser, link, lat


_REFS = {}


def _references(m, kind, seed):
    """(inputs as tensors, the plain version's output), held once per
    input against the Pallas kernel (interpret) and both oracles."""
    key = (m, kind, seed)
    if key not in _REFS:
        send, ser, link, lat = _msgs(m, kind, seed)
        t = [torch.from_numpy(x) for x in (send, ser, link, lat)]
        plain = tref.hub_route_plain(*t)
        size = np.ones(m, np.int32)
        bw = np.ones(lat.shape[0], np.float32)
        block = min(512, 1 << max(3, (m - 1).bit_length()))
        pallas = jax_hub_route(jnp.asarray(send), jnp.asarray(size),
                               jnp.asarray(link), jnp.asarray(bw),
                               jnp.asarray(lat), ser_ns=jnp.asarray(ser),
                               block=block, interpret=True)
        np.testing.assert_array_equal(plain.numpy(), np.asarray(pallas))
        np.testing.assert_array_equal(
            plain.numpy(), hub_visibility_ref(send, size, link, bw, lat,
                                              ser_ns=ser))
        np.testing.assert_array_equal(
            plain.numpy(), tref.hub_visibility_ref(send, size, link, bw, lat,
                                                   ser_ns=ser))
        _REFS[key] = (t, plain)
    return _REFS[key]


#: (M, tile): tiles of 1 and 7 messages at small M, the kernel's tile
#: around its edges
CASES = [(1, 1), (7, 1), (129, 1), (1, 7), (7, 7), (129, 7), (500, 7),
         (1, TILE), (7, TILE), (129, TILE), (TILE - 1, TILE), (TILE, TILE),
         (TILE + 1, TILE), (3 * TILE + 5, TILE)]


@pytest.mark.parametrize("kind", ["one_link", "per_link", "few"])
@pytest.mark.parametrize("m,tile", CASES)
def test_lookback_vs_plain_pallas_and_oracles(m, tile, kind):
    t, plain = _references(m, kind, seed=m)
    got, _ = lookback(*t, tile, seed=m + tile)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("early_inc", [True, False])
def test_lookback_stops_at_inc_and_at_g(early_inc):
    """Few links over tiles of 7: every tile holds a segment start.  The
    kernel publishes such a tile's INC at once, so a look-back stops at
    an INC; with aggregates published instead (``early_inc`` False) the
    same look-backs stop at an aggregate with G, and give the same
    bits."""
    rng = np.random.default_rng(7)
    link = np.arange(500, dtype=np.int32) // 5          # 5 messages a link
    send = np.sort(rng.integers(0, 1_000, (100, 5)), axis=1)
    t = [torch.from_numpy(x.astype(np.int32).reshape(-1)) for x in (
        send, rng.integers(0, 300, 500), link, rng.integers(0, 99, 100))]
    plain = tref.hub_route_plain(*t)
    np.testing.assert_array_equal(plain.numpy(), tref.hub_visibility_ref(
        t[0].numpy(), None, link, None, t[3].numpy(), ser_ns=t[1].numpy()))
    got, stats = lookback(*t, 7, seed=3, early_inc=early_inc)
    assert torch.equal(got, plain)
    if early_inc:
        assert stats["stop_inc"] > 0 and stats["stop_g"] == 0
    else:
        assert stats["stop_g"] > 0


def test_one_link_looks_back_over_many_windows():
    """One link, tiles of 1 message: a tile can find only aggregates
    behind it, so its look-back crosses window after window of 32."""
    t, plain = _references(129, "one_link", seed=129)
    found = 0
    for seed in range(4):
        got, stats = lookback(*t, 1, seed=seed)
        assert torch.equal(got, plain)
        found = max(found, stats["windows"])
    assert found > 129 // 32


def test_stale_epochs_in_a_kept_scratch():
    """A scratch left by a larger call, then smaller and larger calls on
    it: flags of earlier calls never match the running call's epoch (its
    polls wait them out), the epoch advances once a call, and every call
    is bit-equal."""
    sc = Scratch(-(-3 * TILE // 7) + 8)
    seen_stale = 0
    for m, kind in ((3 * TILE, "few"), (129, "one_link"), (7, "few"),
                    (500, "per_link"), (3 * TILE, "one_link")):
        t, plain = _references(m, kind, seed=m)
        before = sc.epoch
        got, stats = lookback(*t, 7, sc=sc, seed=m)
        assert torch.equal(got, plain)
        assert sc.epoch == before + 1 and sc.ticket == sc.done == 0
        seen_stale += stats["stale_waits"]
    assert seen_stale > 0
    # slots past the last call's tiles still hold older epochs
    assert all(f[0] < sc.epoch for f in sc.flags)


def test_tile_matches_the_kernel_module():
    assert kmod.TILE == 1024 and kmod.MIN_CAPACITY * kmod.TILE >= 1 << 22
