"""Serving: sampling, the byte and BPE tokenizers, the continuous-batching engine
on the paged KV pool with its tenant/lane scheduler, the model glue and the
HTTP app with ``/chat`` and the OpenAI routes."""

from .app import ChatServer, Context, build_server
from .engine import Engine, EngineConfig, GenRequest, SamplingParams
from .handlers import admission_error, make_chat_handler
from .openai_compat import OpenAIRoutes, install_openai_routes
from .responses import ClientGone, HTTPError, Raw, Stream
from .scheduler import (BACKGROUND, INTERACTIVE, QUEUE_FULL, RATE_LIMITED,
                        RateLimit, SchedReject, Scheduler, SchedulerConfig,
                        retry_after_header)

__all__ = ["BACKGROUND", "ChatServer", "ClientGone", "Context", "Engine",
           "EngineConfig", "GenRequest", "HTTPError", "INTERACTIVE",
           "OpenAIRoutes", "QUEUE_FULL", "RATE_LIMITED", "RateLimit", "Raw",
           "SamplingParams", "SchedReject", "Scheduler", "SchedulerConfig",
           "Stream", "admission_error", "build_server",
           "install_openai_routes", "make_chat_handler",
           "retry_after_header"]
