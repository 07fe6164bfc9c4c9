"""Agent + HTTP API (ref command/agent/)."""
from .agent import Agent, AgentConfig  # noqa: F401
from .http import HTTPAPI, HTTPError, make_http_server  # noqa: F401
