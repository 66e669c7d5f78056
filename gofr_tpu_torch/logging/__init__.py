from .logger import (
    DEBUG,
    ERROR,
    FATAL,
    INFO,
    NOTICE,
    WARN,
    ContextLogger,
    Level,
    Logger,
    MockLogger,
    clear_fleet_context,
    current_fleet_context,
    current_trace_ids,
    level_from_string,
    new_file_logger,
    new_logger,
    set_fleet_context,
)

__all__ = [
    "DEBUG", "ERROR", "FATAL", "INFO", "NOTICE", "WARN",
    "ContextLogger", "Level", "Logger", "MockLogger",
    "clear_fleet_context", "current_fleet_context", "current_trace_ids",
    "level_from_string", "new_file_logger", "new_logger",
    "set_fleet_context",
]
