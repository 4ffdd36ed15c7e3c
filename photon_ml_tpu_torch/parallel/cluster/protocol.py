"""Length-prefixed message framing for the cluster plane.

Port of ``photon_ml_tpu/parallel/cluster/protocol.py``, the same code: the
allreduce and control plane is a small coordinator/worker TCP protocol
carrying numpy payloads, not a ``torch.distributed`` collective, because a
collective wedges when one participant dies and the plane must survive a
killed host mid-pass (the reference inherited this from Spark: a lost
executor's partitions are recomputed). Sockets are the failure detector: a
killed process closes its socket; a wedged one stops heartbeating.

Framing is an 8-byte big-endian length prefix followed by a pickled dict.
Payloads stay numpy arrays and Python scalars, never torch tensors, so a
message with the same content pickles to the same bytes in either package.
Pickle is acceptable because both ends are processes this package spawned
on a trusted interconnect; never expose these sockets to untrusted peers.

Message vocabulary (dicts keyed by ``"type"``):

* ``hello``      worker -> coordinator: ``host`` id, ``num_blocks`` of its
                 locally planned stream (a config-skewed worker is rejected
                 at the door).
* ``residual``   coordinator -> workers: the CD residual plane for the next
                 solve (once per outer iteration, not per pass).
* ``pass``       coordinator -> worker: ``pass_id``, ``frag``, ``w`` and the
                 ``blocks`` this host streams for this pass; with coordinator
                 telemetry enabled also ``telemetry: True``.
* ``partial``    worker -> coordinator: ``pass_id``/``frag`` echoed, the
                 host's partial ``f``/``g`` sums and per-block stats; when
                 asked, a ``telemetry`` dict of the fragment's timings
                 (``busy_s``/``decode_s``/``solve_s``/``reply_s``, ``blocks``,
                 ``h2d_bytes``). With telemetry off both messages carry no
                 extra key.
* ``heartbeat``  worker -> coordinator: liveness, from a thread of its own so
                 a long first-use kernel build never reads as death.
* ``stop``       coordinator -> workers: drain and exit 0.
"""

from __future__ import annotations

import pickle
import socket
import struct
import threading
from typing import Any, Optional, Tuple

_HEADER = struct.Struct("!Q")
# Guard against a corrupt/hostile length prefix allocating the world.
MAX_MESSAGE_BYTES = 1 << 33


class ProtocolError(RuntimeError):
    """A malformed frame (bad length, truncated payload)."""


def send_msg(sock: socket.socket, obj: Any) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_HEADER.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        read = sock.recv_into(view[got:], n - got)
        if read == 0:
            raise EOFError("peer closed the connection")
        got += read
    return bytes(buf)


def recv_msg(sock: socket.socket) -> Any:
    (length,) = _HEADER.unpack(_recv_exact(sock, _HEADER.size))
    if length > MAX_MESSAGE_BYTES:
        raise ProtocolError(f"frame of {length} bytes exceeds cap")
    return pickle.loads(_recv_exact(sock, length))


class MessageSocket:
    """A framed socket with a send lock, so the heartbeat thread and the
    main loop can interleave sends without tearing frames."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._send_lock = threading.Lock()

    def send(self, obj: Any) -> None:
        with self._send_lock:
            send_msg(self.sock, obj)

    def recv(self) -> Any:
        return recv_msg(self.sock)

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


def connect(address: Tuple[str, int], timeout: Optional[float] = None) -> MessageSocket:
    sock = socket.create_connection(address, timeout=timeout)
    sock.settimeout(None)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return MessageSocket(sock)
