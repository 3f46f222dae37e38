"""Raise OS file-descriptor limits (a copy of hivemind_tpu/utils/limits.py; the
reference's hivemind/utils/limits.py): swarm peers hold many sockets."""

from __future__ import annotations

from hivemind_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def increase_file_limit(new_soft: int = 2**15, new_hard: int = 2**15) -> None:
    """Best-effort bump of RLIMIT_NOFILE up to the allowed hard limit."""
    try:
        import resource

        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        if hard == resource.RLIM_INFINITY:
            # never LOWER an unlimited hard limit (RLIM_INFINITY is -1: naive max()
            # would irreversibly clamp it)
            target_hard = resource.RLIM_INFINITY
            target_soft = max(soft, new_soft)
        else:
            target_hard = hard
            target_soft = min(max(soft, new_soft), hard)
        if target_soft > soft:
            resource.setrlimit(resource.RLIMIT_NOFILE, (target_soft, target_hard))
            logger.info(f"raised file limit: {soft} -> {target_soft}")
    except Exception as e:
        logger.warning(f"could not increase file limit: {e!r}")
