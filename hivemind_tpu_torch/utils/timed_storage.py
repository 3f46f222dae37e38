"""Swarm time (the port's copy of ``get_dht_time`` from hivemind_tpu/utils/timed_storage.py)."""

import time


def get_dht_time() -> float:
    """Global swarm time, approximated as local UNIX time (peers tolerate skew)."""
    return time.time()
