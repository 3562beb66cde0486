"""Minimal TensorBoard event-file writer (stdlib only).

The training service logs metrics to JSONL (`metrics.jsonl`); the reference
manages a real TensorBoard over tfevents logs
(acestep/api_server.py:557-622). This module bridges the
two: it serializes scalar summaries into the tfevents wire format —
TFRecord framing (length + masked CRC32C) around hand-encoded `Event`
protos — so `/v1/training/tensorboard/start` can serve a real dashboard
without TensorFlow/torch imports in the serving path.

Wire format notes (protobuf):
  Event:   wall_time=1 (double), step=2 (int64), file_version=3 (string),
           summary=5 (message)
  Summary: value=1 (repeated message)
  Value:   tag=1 (string), simple_value=2 (float)
"""

from __future__ import annotations

import json
import os
import struct
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

# -- CRC32C (Castagnoli, reflected poly 0x82F63B78), table-driven ----------

_CRC_TABLE: List[int] = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- protobuf primitives ----------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_double(num: int, value: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", value)


def _field_varint(num: int, value: int) -> bytes:
    return _varint((num << 3) | 0) + _varint(value)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _field_float(num: int, value: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", value)


def _scalar_event(wall_time: float, step: int,
                  scalars: Dict[str, float]) -> bytes:
    values = b"".join(
        _field_bytes(1, _field_bytes(1, tag.encode("utf-8"))
                     + _field_float(2, float(v)))
        for tag, v in scalars.items())
    return (_field_double(1, wall_time) + _field_varint(2, max(0, int(step)))
            + _field_bytes(5, values))


def _record(event: bytes) -> bytes:
    header = struct.pack("<Q", len(event))
    return (header + struct.pack("<I", _masked_crc(header))
            + event + struct.pack("<I", _masked_crc(event)))


# -- public API --------------------------------------------------------------

def write_scalar_events(path: str,
                        records: Iterable[Tuple[int, float,
                                                Dict[str, float]]]) -> str:
    """Write (step, wall_time, {tag: value}) records as one tfevents file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        # conventional first record: file-format version stamp
        f.write(_record(_field_double(1, time.time())
                        + _field_bytes(3, b"brain.Event:2")))
        for step, wall_time, scalars in records:
            if scalars:
                f.write(_record(_scalar_event(wall_time, step, scalars)))
    os.replace(tmp, path)
    return path


def export_metrics_jsonl(metrics_path: str, logdir: str,
                         tag: str = "train/loss") -> Optional[str]:
    """metrics.jsonl -> tfevents under logdir. Returns the event file path,
    or None when there are no plottable records."""
    records: List[Tuple[int, float, Dict[str, float]]] = []
    try:
        with open(metrics_path, "r", encoding="utf-8") as f:
            for line in f:
                try:
                    rec: Dict[str, Any] = json.loads(line)
                except ValueError:
                    continue
                if rec.get("loss") is None:
                    continue
                records.append((int(rec.get("step", len(records))),
                                float(rec.get("ts", 0.0)),
                                {tag: float(rec["loss"])}))
    except OSError:
        return None
    if not records:
        return None
    # stable filename: a re-export (second run into the same output_dir)
    # REPLACES the previous file — two event files in one logdir would be
    # merged by TensorBoard into a confusing overlay of both runs
    path = os.path.join(logdir, "events.out.tfevents.0.jsonl-export")
    return write_scalar_events(path, records)


def has_event_files(logdir: str) -> bool:
    for _root, _dirs, files in os.walk(logdir):
        if any("tfevents" in name for name in files):
            return True
    return False
