"""API configuration (env-driven).

Parity: reference `api/config.py` — pydantic-settings-style env config:
host/port/debug, CORS origins, index path, templates path, question length
limit, log level. Implemented with plain pydantic + os.environ (the
pydantic-settings package is not a baked-in dependency).
"""

from __future__ import annotations

import os

from pydantic import BaseModel


class APIConfig(BaseModel):
    host: str = "0.0.0.0"
    port: int = 8000
    debug: bool = False
    cors_origins: list[str] = ["*"]
    index_path: str = "./verbatim_index"
    templates_path: str = ""
    max_question_length: int = 1000
    log_level: str = "INFO"
    llm_model: str = ""
    llm_api_base: str = "https://api.openai.com/v1"
    #: server-side micro-batching of concurrent /api/query requests
    micro_batch: bool = True
    micro_batch_max: int = 64
    micro_batch_wait_ms: float = 4.0

    @classmethod
    def from_env(cls) -> "APIConfig":
        def env(name: str, default: str = "") -> str:
            return os.environ.get(name, default)

        return cls(
            host=env("API_HOST", "0.0.0.0"),
            port=int(env("API_PORT", "8000")),
            debug=env("API_DEBUG", "").lower() in ("1", "true"),
            # Strip per-origin whitespace: 'https://a.com, https://b.com'
            # must match a request Origin of 'https://b.com'.
            cors_origins=[
                o.strip()
                for o in (env("CORS_ORIGINS", "*") or "*").split(",")
                if o.strip()
            ]
            or ["*"],
            index_path=env("INDEX_PATH", "./verbatim_index"),
            templates_path=env("TEMPLATES_PATH", ""),
            max_question_length=int(env("MAX_QUESTION_LENGTH", "1000")),
            log_level=env("LOG_LEVEL", "INFO"),
            llm_model=env("LLM_MODEL", ""),
            llm_api_base=env("LLM_API_BASE", "https://api.openai.com/v1"),
            micro_batch=env("MICRO_BATCH", "1").strip().lower()
            not in ("0", "false", "no", "off"),
            micro_batch_max=int(env("MICRO_BATCH_MAX", "64")),
            micro_batch_wait_ms=float(env("MICRO_BATCH_WAIT_MS", "4.0")),
        )
