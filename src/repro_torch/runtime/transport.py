"""Checksummed, sequence-numbered delivery for nomadic items.

NOMAD's data plane is the stream of ``(j, h_j)`` ownership transfers
(Alg. 1 line 22).  The engine and the simulator historically assumed a
perfect network: every "arrive" event lands intact, exactly once, in
send order.  This module is the delivery abstraction that drops that
assumption:

* **Envelope** — the wire unit: source, destination, a per-sender
  sequence number, the payload bytes, and a CRC32 over the payload.  A
  bit-flipped envelope fails :meth:`Envelope.verify` and is discarded
  at the receiver (equivalent to a drop; retransmission covers it).
* **ItemLedger** — exactly-once *circulation* despite at-least-once
  *delivery*.  Every logical transfer of item ``j`` bumps a per-item
  version; retransmits and link-level duplicates reuse the version and
  are idempotent (``accept`` returns ``True`` once per version), while
  a failure-driven re-route bumps it so a late copy of the superseded
  transfer can never put ``j`` into circulation twice.  This is the
  invariant serializability rests on: one worker at a time owns
  ``h_j``.
* **TransportConfig** — the retransmission policy: at-least-once with
  exponential backoff, and a bounded retry budget after which the
  sender falls back to a reliable (re-routed) delivery so an
  adversarial fault script cannot starve an item out of circulation.

The event mechanics (timers, acknowledgement hops, fault injection)
live with the host — the JAX package's ``core.async_sim.NomadSimulator``
(not ported yet: ROADMAP.md Queue 1 item 7)
prices every transmission and acknowledgement through its ``ship()``
closure and draws faults from a
:class:`~repro_torch.runtime.chaos.DegradedLink` — so this module stays pure
bookkeeping and is unit-testable without a simulator.
"""
from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Dict, Optional, Tuple

__all__ = ["Envelope", "TransportConfig", "ItemLedger", "TransportStats",
           "seal", "encode_item", "decode_item", "flip_bit"]


# --------------------------------------------------------------------- #
# Payload codec                                                          #
# --------------------------------------------------------------------- #

_ITEM = struct.Struct(">qq")    # (item id, transfer version)


def encode_item(j: int, ver: int) -> bytes:
    """Wire payload of one nomadic transfer: item id + transfer version
    (big-endian int64 pair).  The factor vector ``h_j`` itself is not
    materialized — the simulator's numerics live in shared host arrays —
    but the integrity layer checksums exactly the bytes a real sender
    would have to protect."""
    return _ITEM.pack(j, ver)


def decode_item(payload: bytes) -> Tuple[int, int]:
    """Inverse of :func:`encode_item`; raises ``ValueError`` on a
    malformed (e.g. truncated) payload."""
    try:
        return _ITEM.unpack(payload)
    except struct.error as e:
        raise ValueError(f"malformed item payload: {e}") from None


def flip_bit(payload: bytes, bit: int) -> bytes:
    """Flip one bit of ``payload`` (the corruption fault model)."""
    if not payload:
        return payload
    bit %= len(payload) * 8
    buf = bytearray(payload)
    buf[bit // 8] ^= 1 << (bit % 8)
    return bytes(buf)


# --------------------------------------------------------------------- #
# Envelope                                                               #
# --------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class Envelope:
    """One wire message: ``(src, dst, seq, payload, crc)``.

    ``seq`` is unique per sender (monotone), so a ``(src, seq)`` pair
    names one transmission attempt's logical message across retries.
    ``crc`` is CRC32 over the payload bytes only — headers are assumed
    protected by the link layer, the payload is what a bit flip in a
    buffer or on the wire corrupts."""
    src: int
    dst: int
    seq: int
    payload: bytes
    crc: int

    def verify(self) -> bool:
        """True iff the payload matches its checksum."""
        return (zlib.crc32(self.payload) & 0xFFFFFFFF) == self.crc

    def corrupted(self, bit: int) -> "Envelope":
        """A copy with one payload bit flipped (crc kept — so
        :meth:`verify` fails, which is the point)."""
        return dataclasses.replace(self,
                                   payload=flip_bit(self.payload, bit))


def seal(src: int, dst: int, seq: int, payload: bytes) -> Envelope:
    """Build a checksummed envelope."""
    return Envelope(src=src, dst=dst, seq=seq, payload=payload,
                    crc=zlib.crc32(payload) & 0xFFFFFFFF)


# --------------------------------------------------------------------- #
# Retransmission policy                                                  #
# --------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class TransportConfig:
    """At-least-once delivery knobs (frozen, validated).

    timeout     -- virtual-time retransmission timeout for the first
                   attempt; ``None`` derives ``timeout_hops`` base hop
                   latencies at wiring time (the simulator knows its
                   ``c * k``).
    backoff     -- exponential backoff multiplier between retries.
    max_retries -- faulty transmission attempts before the sender falls
                   back to a reliable re-routed delivery (so a scripted
                   100%-drop window can delay an item but never starve
                   it out of circulation).
    """
    timeout: Optional[float] = None
    timeout_hops: float = 4.0
    backoff: float = 2.0
    max_retries: int = 5

    def __post_init__(self):
        if self.timeout is not None and self.timeout <= 0:
            raise ValueError(f"timeout must be > 0, got {self.timeout}")
        if self.timeout_hops <= 0:
            raise ValueError(
                f"timeout_hops must be > 0, got {self.timeout_hops}")
        if self.backoff < 1.0:
            raise ValueError(f"backoff must be >= 1, got {self.backoff}")
        if self.max_retries < 1:
            raise ValueError(
                f"max_retries must be >= 1, got {self.max_retries}")

    def retry_delay(self, base_timeout: float, attempts: int) -> float:
        """Backoff schedule: delay before the ``attempts``-th retry
        (``attempts`` >= 1 transmission already made)."""
        return base_timeout * self.backoff ** (attempts - 1)


# --------------------------------------------------------------------- #
# Receiver-side dedup / idempotent apply                                 #
# --------------------------------------------------------------------- #

@dataclasses.dataclass
class TransportStats:
    """Counters the integrity layer reports (``SimResult`` /
    ``FitResult.extras['transport']``)."""
    sent: int = 0            # logical transfers launched
    transmissions: int = 0   # wire attempts (incl. retries/fallbacks)
    delivered: int = 0       # accepted exactly-once deliveries
    duplicates: int = 0      # deduped copies (link dup or retransmit)
    stale: int = 0           # superseded-version copies discarded
    corrupt: int = 0         # checksum failures discarded
    dropped: int = 0         # link drops
    retransmits: int = 0     # timer-driven resends
    reroutes: int = 0        # version bumps (dead destination / budget)

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


class ItemLedger:
    """Exactly-once circulation ledger for nomadic items.

    ``launch(j)`` starts a new logical transfer of item ``j`` and
    returns its version; ``accept(j, ver)`` is the receiver's idempotent
    apply — ``True`` exactly once per current version, ``False`` for
    link duplicates, retransmitted copies already applied, and stale
    (superseded) versions.  The ledger is the session-level dedup the
    envelope sequence numbers feed: seq names the message, (item,
    version) names the ownership transfer."""

    def __init__(self, n_items: int):
        if n_items < 0:
            raise ValueError(f"n_items must be >= 0, got {n_items}")
        self._ver = [0] * n_items
        self._delivered = [-1] * n_items   # newest version applied
        self.stats = TransportStats()

    def launch(self, j: int) -> int:
        """Open transfer version for item ``j`` (bumps; any in-flight
        older copy becomes stale)."""
        self._ver[j] += 1
        self.stats.sent += 1
        return self._ver[j]

    def version(self, j: int) -> int:
        return self._ver[j]

    def delivered(self, j: int, ver: int) -> bool:
        """Has version ``ver`` of item ``j`` already been applied?"""
        return self._delivered[j] >= ver

    def accept(self, j: int, ver: int) -> bool:
        """Idempotent apply: ``True`` iff this copy is the first intact
        delivery of the *current* transfer of ``j``."""
        if ver < self._ver[j]:
            self.stats.stale += 1
            return False
        if self._delivered[j] >= ver:
            self.stats.duplicates += 1
            return False
        self._delivered[j] = ver
        self.stats.delivered += 1
        return True
