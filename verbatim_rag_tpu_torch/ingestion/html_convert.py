"""Native HTML → markdown conversion (stdlib html.parser).

Copy of `verbatim_rag_tpu/ingestion/html_convert.py` (pinned by
`tests/test_torch_copies.py`): headings, paragraphs, lists, tables, links,
emphasis and code map to the markdown the lossless chunker consumes;
script/style/nav boilerplate is dropped. Exotic layouts still route to the
pluggable converter of `document_processor.py` (docling when importable).
"""

from __future__ import annotations

import re
from html.parser import HTMLParser

_SKIP = {"script", "style", "noscript", "head", "template"}
_BLOCK_BREAK = {"p", "div", "section", "article", "br", "tr", "table", "ul", "ol"}
_HEADINGS = {"h1": "#", "h2": "##", "h3": "###", "h4": "####", "h5": "#####", "h6": "######"}


class _Markdownifier(HTMLParser):
    def __init__(self) -> None:
        super().__init__(convert_charrefs=True)
        self.out: list[str] = []
        self._skip_depth = 0
        self._pre_depth = 0
        self._list_stack: list[str] = []  # "ul" | "ol"
        self._ol_counters: list[int] = []
        self._href: str | None = None
        self._link_text: list[str] = []
        self._in_cell = False
        self._row: list[str] = []
        self._table_rows: list[list[str]] = []
        self._in_table = False

    # -- emit helpers -----------------------------------------------------------

    def _emit(self, text: str) -> None:
        if self._href is not None:
            self._link_text.append(text)
        elif self._in_cell:
            self._row[-1] += text
        else:
            self.out.append(text)

    def _break(self) -> None:
        if not self._in_cell and self._href is None:
            self.out.append("\n\n")

    # -- parser hooks -------------------------------------------------------------

    def handle_starttag(self, tag, attrs):
        if tag in _SKIP:
            self._skip_depth += 1
            return
        if self._skip_depth:
            return
        if tag in _HEADINGS:
            self.out.append(f"\n\n{_HEADINGS[tag]} ")
        elif tag == "pre":
            self._pre_depth += 1
            self.out.append("\n\n```\n")
        elif tag == "code" and not self._pre_depth:
            self._emit("`")
        elif tag in ("strong", "b"):
            self._emit("**")
        elif tag in ("em", "i"):
            self._emit("*")
        elif tag == "a":
            self._href = dict(attrs).get("href") or ""
            self._link_text = []
        elif tag in ("ul", "ol"):
            self._list_stack.append(tag)
            if tag == "ol":
                self._ol_counters.append(0)
            self.out.append("\n")
        elif tag == "li":
            indent = "  " * (len(self._list_stack) - 1)
            if self._list_stack and self._list_stack[-1] == "ol":
                self._ol_counters[-1] += 1
                self.out.append(f"\n{indent}{self._ol_counters[-1]}. ")
            else:
                self.out.append(f"\n{indent}- ")
        elif tag == "table":
            self._in_table = True
            self._table_rows = []
        elif tag == "tr" and self._in_table:
            self._row = []
        elif tag in ("td", "th") and self._in_table:
            self._in_cell = True
            self._row.append("")
        elif tag in _BLOCK_BREAK:
            self._break()

    def handle_endtag(self, tag):
        if tag in _SKIP:
            self._skip_depth = max(0, self._skip_depth - 1)
            return
        if self._skip_depth:
            return
        if tag in _HEADINGS:
            self.out.append("\n\n")
        elif tag == "pre":
            self._pre_depth = max(0, self._pre_depth - 1)
            self.out.append("\n```\n\n")
        elif tag == "code" and not self._pre_depth:
            self._emit("`")
        elif tag in ("strong", "b"):
            self._emit("**")
        elif tag in ("em", "i"):
            self._emit("*")
        elif tag == "a":
            text = "".join(self._link_text).strip()
            href, self._href = self._href, None
            if text and href and not href.startswith(("#", "javascript:")):
                self.out.append(f"[{text}]({href})")
            elif text:
                self.out.append(text)
        elif tag in ("ul", "ol"):
            if self._list_stack:
                popped = self._list_stack.pop()
                if popped == "ol" and self._ol_counters:
                    self._ol_counters.pop()
            self.out.append("\n")
        elif tag in ("td", "th"):
            self._in_cell = False
        elif tag == "tr" and self._in_table:
            if self._row:
                self._table_rows.append([c.strip() for c in self._row])
        elif tag == "table":
            self._in_table = False
            if self._table_rows:
                head, *body = self._table_rows
                md = ["| " + " | ".join(head) + " |", "|" + "---|" * len(head)]
                md += ["| " + " | ".join(r) + " |" for r in body]
                self.out.append("\n\n" + "\n".join(md) + "\n\n")
        elif tag in _BLOCK_BREAK:
            self._break()

    def handle_data(self, data):
        if self._skip_depth:
            return
        if self._pre_depth:
            self.out.append(data)
        else:
            text = re.sub(r"\s+", " ", data)
            if text.strip() or (self.out and not self.out[-1].endswith("\n")):
                self._emit(text)


def html_to_markdown(html: str) -> str:
    """Convert an HTML document/fragment to chunker-ready markdown."""
    parser = _Markdownifier()
    parser.feed(html)
    parser.close()
    text = "".join(parser.out)
    # Collapse runs of blank lines and trailing space-per-line.
    text = re.sub(r"[ \t]+\n", "\n", text)
    text = re.sub(r"\n{3,}", "\n\n", text)
    return text.strip() + "\n"
