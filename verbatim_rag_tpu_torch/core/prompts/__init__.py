"""Prompt bank: Jinja2 templates for extraction and template generation.

Parity: reference `verbatim_core/prompts/__init__.py` — prompts live as
``.txt`` files addressed by relative name (``extraction/default``), rendered
with Jinja2 so custom prompts can use ``{{ var }}`` and ``{% if %}`` blocks.
"""

from __future__ import annotations

from pathlib import Path

from jinja2 import Environment, FileSystemLoader

PROMPTS_DIR = Path(__file__).parent

_env = Environment(
    loader=FileSystemLoader(str(PROMPTS_DIR)),
    keep_trailing_newline=True,
    trim_blocks=True,
    lstrip_blocks=True,
)


def render_prompt(prompt_template: str, **variables) -> str:
    """Render an inline Jinja2 template string."""
    return _env.from_string(prompt_template).render(**variables)


def load_prompt(name: str, **variables) -> str:
    """Load a prompt by name; render it when variables are given."""
    path = PROMPTS_DIR / f"{name}.txt"
    if not path.exists():
        raise FileNotFoundError(f"Prompt not found: {name} (looked in {path})")
    if variables:
        return _env.get_template(f"{name}.txt").render(**variables)
    return path.read_text(encoding="utf-8")


def list_prompts() -> list[str]:
    """Names of every prompt in the bank."""
    return sorted(
        str(p.relative_to(PROMPTS_DIR)).removesuffix(".txt") for p in PROMPTS_DIR.rglob("*.txt")
    )
