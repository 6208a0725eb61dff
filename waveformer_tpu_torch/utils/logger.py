"""Logging: one package logger with separate file and console levels, and
a from-scratch TensorBoard event writer.

A copy of `waveformer_tpu/utils/logger.py`:
  * the logger (reference `Logger`, `lib/utils/tools/logger.py:31-204` via
    `utils/logger_setup.py:12-74`);
  * `SummaryWriter`: scalar tfevents files (tfrecord framing with masked
    crc32c and a minimal Event/Summary protobuf encoder), so TensorBoard
    reads them with no tensorboard package, and a JSONL mirror. For the same
    scalars and clock its records are byte-equal to the JAX package's.
"""

from __future__ import annotations

import json
import logging
import os
import struct
import sys
import time
from typing import Dict, Optional

# --------------------------------------------------------------------------- #
# file + console logger
# --------------------------------------------------------------------------- #

_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}

_DEFAULT_FORMAT = "%(asctime)s %(levelname)-7s [%(filename)s:%(lineno)d] %(message)s"

_logger: Optional[logging.Logger] = None


def setup_logging(
    log_file: str = "./logs/training.log",
    file_level: str = "debug",
    console_level: str = "info",
    write_to_file: bool = True,
    write_to_console: bool = True,
    rewrite: bool = False,
    fmt: str = _DEFAULT_FORMAT,
    name: str = "waveformer_tpu_torch",
) -> logging.Logger:
    """Configure the package logger (reference `setup_logging`,
    `utils/logger_setup.py:12-74`)."""
    global _logger
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    for h in logger.handlers:
        h.close()
    logger.handlers.clear()
    logger.propagate = False
    formatter = logging.Formatter(fmt)
    if write_to_console:
        ch = logging.StreamHandler(sys.stdout)
        ch.setLevel(_LEVELS[console_level])
        ch.setFormatter(formatter)
        logger.addHandler(ch)
    if write_to_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        fh = logging.FileHandler(log_file, mode="w" if rewrite else "a")
        fh.setLevel(_LEVELS[file_level])
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    _logger = logger
    return logger


def get_logger(name: str = "waveformer_tpu_torch") -> logging.Logger:
    """(reference `get_logger`)."""
    global _logger
    if _logger is None:
        _logger = setup_logging(write_to_file=False)
    return _logger


def setup_logging_from_config(cfg) -> logging.Logger:
    """Wire a `waveformer_tpu_torch.config.LoggingConfig`."""
    if not cfg.enabled:
        return setup_logging(write_to_file=False, write_to_console=False)
    return setup_logging(
        log_file=cfg.log_file,
        file_level=cfg.log_level_file,
        console_level=cfg.log_level_console,
        write_to_file=cfg.write_to_file,
        write_to_console=cfg.write_to_console,
        rewrite=cfg.rewrite_log,
    )
# --------------------------------------------------------------------------- #
# crc32c (software, Castagnoli polynomial) — needed for tfrecord framing
# --------------------------------------------------------------------------- #

_CRC_TABLE = []


def _build_crc_table():
    poly = 0x82F63B78
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_build_crc_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    rotated = ((crc >> 15) | (crc << 17)) & 0xFFFFFFFF
    return (rotated + 0xA282EAD8) & 0xFFFFFFFF


# --------------------------------------------------------------------------- #
# minimal protobuf encoding for Event{wall_time, step, summary{value{tag,
# simple_value}}}
# --------------------------------------------------------------------------- #


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b7 | 0x80])
        else:
            return out + bytes([b7])


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _encode_summary_value(tag: str, value: float) -> bytes:
    tag_b = tag.encode()
    body = (
        _field(1, 2) + _varint(len(tag_b)) + tag_b  # tag
        + _field(2, 5) + struct.pack("<f", value)  # simple_value
    )
    return body


def _encode_event(step: int, tag: str, value: float, wall_time: float) -> bytes:
    sv = _encode_summary_value(tag, value)
    summary = _field(1, 2) + _varint(len(sv)) + sv  # Summary.value
    event = (
        _field(1, 1) + struct.pack("<d", wall_time)  # wall_time
        + _field(2, 0) + _varint(step)  # step (non-negative here)
        + _field(5, 2) + _varint(len(summary)) + summary  # summary
    )
    return event


class SummaryWriter:
    """Scalar-only TensorBoard writer + JSONL mirror
    (capability of `torch.utils.tensorboard.SummaryWriter` scalars as used at
    `light_training/trainer.py:495-502`)."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.waveformer_tpu_torch"
        self._path = os.path.join(logdir, fname)
        self._f = open(self._path, "ab")
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        # file-version header event
        self._write_record(
            _field(1, 1) + struct.pack("<d", time.time())
            + _field(3, 2) + _varint(len(b"brain.Event:2")) + b"brain.Event:2"
        )

    def _write_record(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int):
        wall = time.time()
        self._write_record(_encode_event(int(step), tag, float(value), wall))
        self._jsonl.write(
            json.dumps({"tag": tag, "value": float(value), "step": int(step),
                        "time": wall})
            + "\n"
        )
        self._jsonl.flush()

    def add_scalars(self, scalars: Dict[str, float], step: int):
        for tag, v in scalars.items():
            self.add_scalar(tag, v, step)

    def close(self):
        self._f.close()
        self._jsonl.close()
