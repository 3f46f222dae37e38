"""Per-link wire-codec negotiation for the butterfly all-reduce (the port of
hivemind_tpu/averaging/wire_codec.py).

The averaging wire supports a small ladder of **tiers** — ``none`` (raw fp32
or native dtype), ``float16``, ``uniform8``, ``blockwise8`` — ordered by how
few bytes they put on the wire. Which tier a *link* (an ordered pair of
groupmates) uses is negotiated with ZERO extra round trips, mirroring the
``peer|codec`` DHT records of the serving path: every peer's
matchmaking gather blob carries a :func:`make_advert` — the tiers it supports,
its default tier, and any per-peer **demotions** its straggler policy has
decided — and both endpoints of a link run the same pure function
(:func:`negotiate_link`) over the two adverts, so they agree without talking.

The adaptive part is :class:`LinkCodecPolicy`: it reads the
:class:`~hivemind_tpu_torch.telemetry.ledger.RoundLedger`'s per-peer straggler
scores (which name each round's slowest exchange partner and its excess
seconds over the round median), demotes chronically slow links to the 8-bit
tier, and promotes them back after a sustained clean streak. Decisions are
exposed three ways: a ``hivemind_averaging_link_codec`` gauge per remote, an
``averaging.link_codec`` span event in the flight recorder, and a
demote/promote event ring on the ledger (shown in ``hivemind-top``).

Negotiation rule (symmetric + deterministic): each side's *proposal* for a
link is its demotion for that remote if any, else its default tier; the link
runs at the most-compressed proposal, clamped to the tiers BOTH sides support.
Peers whose gather blob carries no advert (a codec outside the ladder, or a
malformed/absent slot) negotiate nothing — the link falls back to the
averager's configured codec, byte-identical to pre-negotiation behavior.

Version-compat note: this tolerance is one-directional. An UPGRADED peer
decodes legacy 3-slot gather blobs fine, but an older peer's strict
3-tuple unpack cannot read the extended blob — mixed-version swarms must
upgrade together (the usual rule for this codebase; gather-blob consumers are
positional-and-tolerant from here on so the NEXT extension is painless).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Mapping, Optional, Sequence, Tuple

from hivemind_tpu_torch.compression import CompressionBase, CompressionType, get_codec
from hivemind_tpu_torch.telemetry import REGISTRY as _TELEMETRY
from hivemind_tpu_torch.telemetry.tracing import finish_span as _finish_span, start_span as _start_span
from hivemind_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# least → most compressed; rank = index. The order IS the negotiation lattice.
WIRE_TIERS: Tuple[str, ...] = ("none", "float16", "uniform8", "blockwise8")

_TIER_TYPES = {
    "none": CompressionType.NONE,
    "float16": CompressionType.FLOAT16,
    "uniform8": CompressionType.UNIFORM_8BIT,
    "blockwise8": CompressionType.BLOCKWISE_8BIT,
}
_TYPE_TIERS = {value: name for name, value in _TIER_TYPES.items()}

# tiers whose codecs are lossy enough to need error-feedback residuals
# (float16 is excluded on purpose: its wire behavior is pinned bit-identical
# by the partition-equivalence suite and needs no compensation in practice)
EF_TIERS = frozenset(("uniform8", "blockwise8"))

_LINK_CODEC = _TELEMETRY.gauge(
    "hivemind_averaging_link_codec",
    "negotiated wire tier for the averaging link to `remote` "
    "(0=none, 1=float16, 2=uniform8, 3=blockwise8)",
    ("remote",),
)
_LINK_CODEC_EVENTS = _TELEMETRY.counter(
    "hivemind_averaging_link_codec_events_total",
    "adaptive link-codec decisions",
    ("action",),
)

# remote peer ids are swarm-supplied: the gauge keeps only the most recently
# seen remotes, evicting stale series from the registry (a churning swarm must
# not grow the metric — and with it every DHT snapshot — without bound)
_LINK_GAUGE_CAP = 64
_link_gauge_lru: "OrderedDict[str, None]" = OrderedDict()
_link_gauge_lock = threading.Lock()


def _set_link_gauge(remote: str, rank: int) -> None:
    with _link_gauge_lock:
        _LINK_CODEC.set(rank, remote=remote)
        _link_gauge_lru[remote] = None
        _link_gauge_lru.move_to_end(remote)
        while len(_link_gauge_lru) > _LINK_GAUGE_CAP:
            stale, _ = _link_gauge_lru.popitem(last=False)
            _LINK_CODEC.remove(remote=stale)


def tier_rank(tier: str) -> int:
    return WIRE_TIERS.index(tier)


def tier_of_codec(codec: CompressionBase) -> Optional[str]:
    """The wire tier a codec instance belongs to, or None (not on the ladder —
    e.g. MEANSTD_16BIT/QUANTILE_8BIT, which disable negotiation)."""
    return _TYPE_TIERS.get(codec.compression_type)


@dataclass(frozen=True)
class WireLink:
    """Resolved per-link wire behavior, handed to the all-reduce runner."""

    tier: str
    codec: CompressionBase = field(compare=False)
    error_feedback: bool

    @classmethod
    def for_tier(cls, tier: str) -> "WireLink":
        return cls(tier=tier, codec=get_codec(_TIER_TYPES[tier]), error_feedback=tier in EF_TIERS)


def make_advert(
    supported: Sequence[str], default_tier: str, demotions: Optional[Mapping[str, str]] = None
) -> Dict[str, Any]:
    """The msgpack-able advert that rides the matchmaking gather blob."""
    return {
        "t": [tier for tier in supported if tier in _TIER_TYPES],
        "d": default_tier,
        "m": dict(demotions or {}),
    }


def parse_advert(obj: Any) -> Optional[Dict[str, Any]]:
    """Normalize a remote-supplied advert; None for anything malformed (the
    link then falls back to the configured codec — never an exception: gather
    blobs are remote-controlled)."""
    if not isinstance(obj, dict):
        return None
    tiers = obj.get("t")
    default = obj.get("d")
    demotions = obj.get("m", {})
    if not isinstance(tiers, (list, tuple)) or not isinstance(default, str):
        return None
    supported = tuple(t for t in tiers if isinstance(t, str) and t in _TIER_TYPES)
    if default not in supported:
        return None
    clean_demotions = {}
    if isinstance(demotions, dict):
        for peer, tier in demotions.items():
            if isinstance(peer, str) and isinstance(tier, str) and tier in _TIER_TYPES:
                clean_demotions[peer] = tier
    return {"t": supported, "d": default, "m": clean_demotions}


def negotiate_link(
    local_advert: Optional[Dict[str, Any]],
    remote_advert: Optional[Dict[str, Any]],
    local_peer_id: str,
    remote_peer_id: str,
) -> Optional[str]:
    """The tier for the link between local and remote, or None when either end
    did not advertise (caller falls back to its configured codec). Symmetric:
    both endpoints compute the identical answer from the same two adverts."""
    if not local_advert or not remote_advert:
        return None
    common = set(local_advert["t"]) & set(remote_advert["t"])
    if not common:
        return None
    local_proposal = local_advert["m"].get(remote_peer_id, local_advert["d"])
    remote_proposal = remote_advert["m"].get(local_peer_id, remote_advert["d"])
    if local_proposal not in _TIER_TYPES:
        local_proposal = local_advert["d"]
    if remote_proposal not in _TIER_TYPES:
        remote_proposal = remote_advert["d"]
    target = max(tier_rank(local_proposal), tier_rank(remote_proposal))
    feasible = sorted(tier_rank(tier) for tier in common)
    at_or_below = [rank for rank in feasible if rank <= target]
    chosen = at_or_below[-1] if at_or_below else feasible[0]
    return WIRE_TIERS[chosen]


class LinkCodecPolicy:
    """Demote chronically slow links to an 8-bit tier; promote them back after
    a sustained clean streak. Driven by the RoundLedger's straggler scores —
    which are CUMULATIVE, so the policy differences them per :meth:`refresh`
    (one refresh per averaging step) into a bounded rolling window.

    Demotion needs evidence, not noise: *some* peer is slowest every round, so
    a link is demoted only when, within the window, it was the slowest exchange
    in at least ``demote_rounds`` rounds AND its mean excess over the round
    median exceeds ``min_excess_s``. Promotion needs ``promote_after``
    consecutive refreshes in which the peer was never slowest-with-excess.
    State is bounded (``max_peers``, LRU on last sighting) so a churning swarm
    cannot grow it — and :meth:`forget` drops a departed peer outright."""

    def __init__(
        self,
        ledger=None,
        *,
        demote_tier: str = "uniform8",
        default_tier: Optional[str] = None,
        demote_rounds: int = 3,
        min_excess_s: float = 0.15,
        promote_after: int = 8,
        window: int = 16,
        max_peers: int = 256,
    ):
        if ledger is None:
            from hivemind_tpu_torch.telemetry.ledger import LEDGER as ledger  # noqa: PLW0127

        assert demote_tier in _TIER_TYPES
        self._ledger = ledger
        self.demote_tier = demote_tier
        # the tier a promoted link returns to; when known, promote/forget reset
        # the hivemind_averaging_link_codec gauge so it never reads a stale
        # demotion (the owning averager sets this to its configured tier)
        self.default_tier = default_tier if default_tier in _TIER_TYPES else None
        self.demote_rounds = demote_rounds
        self.min_excess_s = min_excess_s
        self.promote_after = promote_after
        self._window_size = window
        self._max_peers = max_peers
        self._last_totals: Dict[str, Tuple[float, float]] = {}
        self._windows: Dict[str, deque] = {}
        self._clean_streak: Dict[str, int] = {}
        self._demoted: Dict[str, str] = {}
        self._last_seen: Dict[str, float] = {}

    def demotions(self) -> Dict[str, str]:
        return dict(self._demoted)

    def refresh(self, exclude: Iterable[str] = ()) -> Dict[str, str]:
        """Fold the latest straggler scores into the windows, apply the
        demote/promote rules, and return the current demotion map (the adverts'
        ``m`` field). Call once per averaging step — cheap: a few dict ops per
        known peer."""
        excluded = set(exclude)
        now = time.monotonic()
        try:
            scores = self._ledger.straggler_scores()
        except Exception:
            return self.demotions()
        for peer, score in scores.items():
            if peer in excluded:
                continue
            totals = (float(score.get("rounds_slowest", 0)), float(score.get("excess_s", 0.0)))
            previous = self._last_totals.get(peer, (0.0, 0.0))
            self._last_totals[peer] = totals
            self._last_seen[peer] = now
            # retro-attribution can MOVE credit between peers (late exchange
            # spans), so deltas may go negative — clamp, it is not new evidence
            delta_slow = max(0.0, totals[0] - previous[0])
            delta_excess = max(0.0, totals[1] - previous[1])
            window = self._windows.setdefault(peer, deque(maxlen=self._window_size))
            window.append((delta_slow, delta_excess))
            if peer in self._demoted:
                if delta_slow > 0 and delta_excess > 0:
                    self._clean_streak[peer] = 0
                else:
                    self._clean_streak[peer] = self._clean_streak.get(peer, 0) + 1
                    if self._clean_streak[peer] >= self.promote_after:
                        self._promote(peer)
            else:
                window_slow = sum(slow for slow, _excess in window)
                window_excess = sum(excess for _slow, excess in window)
                if (
                    window_slow >= self.demote_rounds
                    and window_excess / max(window_slow, 1.0) >= self.min_excess_s
                ):
                    self._demote(peer)
        self._prune()
        return self.demotions()

    def forget(self, peer: str) -> None:
        """A peer departed: drop every trace of it (no-leak guarantee)."""
        for table in (self._last_totals, self._windows, self._clean_streak, self._last_seen):
            table.pop(peer, None)
        if self._demoted.pop(peer, None) is not None:
            _LINK_CODEC_EVENTS.inc(action="forget")
            if self.default_tier is not None:
                _set_link_gauge(peer, tier_rank(self.default_tier))

    def _demote(self, peer: str) -> None:
        self._demoted[peer] = self.demote_tier
        self._clean_streak[peer] = 0
        self._emit(peer, "demote", self.demote_tier)

    def _promote(self, peer: str) -> None:
        self._demoted.pop(peer, None)
        self._clean_streak.pop(peer, None)
        self._windows.pop(peer, None)  # fresh evidence required to re-demote
        self._emit(peer, "promote", None)

    def _emit(self, peer: str, action: str, tier: Optional[str]) -> None:
        logger.info(f"link codec {action}: {peer} -> {tier or 'default'}")
        _LINK_CODEC_EVENTS.inc(action=action)
        effective = tier if tier is not None else self.default_tier
        if effective is not None:
            _set_link_gauge(peer, tier_rank(effective))
        # a detached span so the decision is visible in the flight recorder /
        # GET /trace even when no round is active on this thread
        span = _start_span("averaging.link_codec", remote=peer, action=action, tier=tier or "default")
        _finish_span(span)
        try:
            self._ledger.record_codec_event(peer=peer, action=action, tier=tier)
        except AttributeError:
            pass  # private ledgers in tests may predate the event ring

    def _prune(self) -> None:
        if len(self._last_seen) <= self._max_peers:
            return
        evictable = sorted(
            (peer for peer in self._last_seen if peer not in self._demoted),
            key=lambda peer: self._last_seen[peer],
        )
        for peer in evictable[: len(self._last_seen) - self._max_peers]:
            self.forget(peer)


def publish_link_gauges(links: Mapping[str, str]) -> None:
    """Record the negotiated tier per remote at group-assembly time."""
    for remote, tier in links.items():
        if tier in _TIER_TYPES:
            _set_link_gauge(remote, tier_rank(tier))
