from legion.utils.logging import get_logger, log_metrics  # noqa: F401
