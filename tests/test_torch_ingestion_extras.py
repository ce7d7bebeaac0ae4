"""HTML and URL ingestion, the full `DocumentProcessor` and the extra
chunkers of the PyTorch port against the JAX package's.

Each case feeds the same inputs (the JAX tests' snippets, files written
here, hypothesis-generated HTML) through both packages and compares the
results exactly. URLs go through the processor's ``http_get`` seam, never
the network.
"""

from __future__ import annotations

import dataclasses
import json

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from verbatim_rag_tpu.ingestion import document_processor as jax_dp
from verbatim_rag_tpu.ingestion import extra_chunkers as jax_extra
from verbatim_rag_tpu.ingestion.chunkers import MarkdownChunkerProvider as JaxMarkdown
from verbatim_rag_tpu.ingestion.chunkers import SimpleChunkerProvider as JaxSimple
from verbatim_rag_tpu.ingestion.html_convert import html_to_markdown as jax_html_to_markdown
from verbatim_rag_tpu.ingestion.schema import DocumentSchema as JaxSchema
from verbatim_rag_tpu_torch.ingestion import document_processor as dp
from verbatim_rag_tpu_torch.ingestion import extra_chunkers as extra
from verbatim_rag_tpu_torch.ingestion.chunkers import MarkdownChunkerProvider, SimpleChunkerProvider
from verbatim_rag_tpu_torch.ingestion.html_convert import html_to_markdown
from verbatim_rag_tpu_torch.ingestion.schema import DocumentSchema

SIDES = {"port": dp, "jax": jax_dp}

HTML = """<!DOCTYPE html>
<html><head><title>T</title><style>body{color:red}</style>
<script>alert("never");</script></head>
<body>
<h1>Solar Power</h1>
<p>Panels convert <strong>sunlight</strong> into <em>electricity</em>.</p>
<h2>Types</h2>
<ul><li>Monocrystalline</li><li>Polycrystalline</li></ul>
<ol><li>First step</li><li>Second step</li></ol>
<table><tr><th>Kind</th><th>Eff</th></tr>
<tr><td>Mono</td><td>22%</td></tr></table>
<p>See <a href="https://example.com/docs">the docs</a> and
<a href="#frag">skip me</a>.</p>
<pre>code [1] block
keeps   spacing</pre>
<p>Inline <code>arr[0]</code> stays code.</p>
</body></html>"""

SNIPPETS = [
    HTML,
    "<h1>A</h1><p>Alpha body.</p>",
    "<h1>Remote</h1><p>Fetched body text.</p>",
    "<ul><li>one<ul><li>nested</li></ul></li><li>two</li></ul>",
    "<ol><li>a</li><li>b<ol><li>inner</li></ol></li></ol><b>bold</b> <i>it</i>",
    "<p>text &amp; entities &lt;tag&gt; &#169;</p><br><div>div</div>",
    "<a href='javascript:void(0)'>js</a><a>no href</a><a href='x'></a>",
    "<noscript>hidden</noscript><template>t</template><p>kept</p>",
    "<table><tr><td>only one row</td></tr></table>",
    "<h3>deep</h3><h6>deeper</h6><section><article>art</article></section>",
    "unclosed <p>para <strong>bold",
    "",
]

MD = "# Top\n\nintro text here\n\n## Sub\n\nsub body content with words\n"


def _doc(doc):
    """A chunked Document as plain data, without its random ids."""
    return dict(
        content=doc.content, title=doc.title, source=doc.source, metadata=doc.metadata,
        doc_type=doc.doc_type.value, chunks=[(c.text, c.enhanced_text) for c in doc.chunks],
    )


class Resp:
    def __init__(self, text, ctype):
        self.text = text
        self.headers = {"content-type": ctype}


# -- html_to_markdown -----------------------------------------------------------------


@pytest.mark.parametrize("html", SNIPPETS, ids=range(len(SNIPPETS)))
def test_html_to_markdown_matches_jax(html):
    assert html_to_markdown(html) == jax_html_to_markdown(html)


def test_html_structure_as_jax_tests_it():
    md = html_to_markdown(HTML)
    for piece in (
        "# Solar Power", "## Types", "**sunlight**", "*electricity*", "- Monocrystalline",
        "1. First step", "2. Second step", "| Kind | Eff |", "| Mono | 22% |",
        "[the docs](https://example.com/docs)", "```\ncode [1] block\nkeeps   spacing\n```", "`arr[0]`",
    ):
        assert piece in md
    assert "(#frag)" not in md and "alert" not in md and "color:red" not in md


_TAGS = ["p", "div", "h1", "h2", "h4", "ul", "ol", "li", "strong", "em", "code", "pre", "a", "table",
         "tr", "td", "th", "script", "style", "br", "span", "section", "b", "i"]
_html = st.recursive(
    st.text(alphabet="ab <>&;#\n\té", max_size=12),
    lambda inner: st.builds(
        lambda tag, attr, body: f"<{tag}{attr}>{''.join(body)}</{tag}>",
        st.sampled_from(_TAGS),
        st.sampled_from(["", " href='http://x/y'", " href='#f'", " class=c"]),
        st.lists(inner, max_size=4),
    ),
    max_leaves=20,
)


@settings(max_examples=150, deadline=None)
@given(_html)
def test_generated_html_matches_jax(html):
    assert html_to_markdown(html) == jax_html_to_markdown(html)


# -- the processor --------------------------------------------------------------------


@pytest.mark.parametrize(
    "name,text",
    [
        ("doc.md", MD),
        ("t.csv", "a,b\n1,2\n"),
        ("t.json", '{"k": 1, "list": [1, 2]}'),
        ("page.html", HTML),
        ("page.htm", "<h1>A</h1><p>Alpha body.</p>"),
        ("notes.txt", "plain text body. " * 10),
    ],
)
def test_process_file_matches_jax(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    got = {side: _doc(mod.DocumentProcessor().process_file(str(path), author="me")) for side, mod in SIDES.items()}
    assert got["port"] == got["jax"]
    assert got["port"]["chunks"] and got["port"]["metadata"] == {"author": "me"}
    assert dp.DocumentProcessor().extract_content_from_file(str(path)) == (
        jax_dp.DocumentProcessor().extract_content_from_file(str(path))
    )


def test_process_directory_mixes_native_and_converted_like_jax(tmp_path):
    """Markdown, text, CSV, JSON and HTML natively, a PDF through the
    converter, a bad JSON file skipped and an unknown suffix ignored."""
    (tmp_path / "a.md").write_text("# A\n\n" + "native markdown text. " * 10)
    (tmp_path / "b.txt").write_text("plain text body. " * 10)
    (tmp_path / "c.bin").write_text("ignored")
    (tmp_path / "d.html").write_text(HTML)
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "e.csv").write_text("x,y\n3,4\n")
    (tmp_path / "sub" / "f.json").write_text("{not json")
    (tmp_path / "g.pdf").write_bytes(b"%PDF-1.4 fake")
    converted = "# Converted\n\nFirst paragraph of converted output.\n\n## Section\n\nSecond paragraph."

    def run(mod, extensions):
        calls = []

        def convert(source):
            calls.append(source)
            return converted

        processor = mod.DocumentProcessor(converter=convert)
        return [_doc(d) for d in processor.process_directory(str(tmp_path), extensions)], calls

    for extensions in ((".md", ".txt", ".csv", ".json", ".html", ".htm"), (".md", ".html", ".pdf", ".json")):
        ours, theirs = run(dp, extensions), run(jax_dp, extensions)
        assert ours == theirs
    titles = [d["title"] for d in ours[0]]
    assert titles == ["a.md", "d.html", "g.pdf"] and ours[1] == [str(tmp_path / "g.pdf")]


@pytest.mark.parametrize(
    "reply",
    [
        Resp("<h1>Remote</h1><p>Fetched body text.</p>", "text/html; charset=utf-8"),
        Resp("<html><body><p>xhtml</p></body></html>", "application/xhtml+xml"),
        Resp("# Plain markdown\n\nbody", "text/markdown"),
        Resp("just text", "text/plain"),
        Resp(b"%PDF", "application/pdf"),
        OSError("no network"),
    ],
    ids=["html", "xhtml", "markdown", "text", "pdf", "fetch_fails"],
)
def test_process_url_through_http_get_matches_jax(reply):
    """HTML, XHTML, markdown and text convert natively; other content types
    and a failed fetch go to the converter, as in JAX."""
    def run(mod):
        calls = []

        def get(url):
            calls.append(("get", url))
            if isinstance(reply, Exception):
                raise reply
            return reply

        def convert(source):
            calls.append(("convert", source))
            return "# Converted\n\nVia converter."

        processor = mod.DocumentProcessor(converter=convert)
        processor.http_get = get
        return _doc(processor.process_url("https://example.com/page", origin="web")), calls

    ours, theirs = run(dp), run(jax_dp)
    assert ours == theirs
    assert ours[0]["chunks"] and ours[0]["metadata"] == {"origin": "web"}


def test_schema_from_url_returns_the_converted_page(monkeypatch):
    """`DocumentSchema.from_url` fetches and converts the page, as in JAX
    (the port's stub processor had no `extract_content_from_url`)."""
    page = Resp(HTML, "text/html")
    for mod in (dp, jax_dp):
        monkeypatch.setattr(mod.DocumentProcessor, "http_get", staticmethod(lambda url: page), raising=False)
    ours = DocumentSchema.from_url("https://example.com/solar.html", metadata={"k": "v"})
    theirs = JaxSchema.from_url("https://example.com/solar.html", metadata={"k": "v"})
    assert ours.model_dump() == theirs.model_dump()
    assert ours.content == html_to_markdown(HTML) and ours.title == "https://example.com/solar.html"


def test_default_converter_needs_docling_like_jax(tmp_path):
    import importlib.util

    assert importlib.util.find_spec("docling") is None  # not installed here
    pdf = tmp_path / "x.pdf"
    pdf.write_bytes(b"%PDF-1.4")
    messages = []
    for mod in (dp, jax_dp):
        with pytest.raises(RuntimeError, match="docling") as err:
            mod.DocumentProcessor().process_file(str(pdf))
        messages.append(str(err.value))
    assert messages[0] == messages[1]


@pytest.mark.parametrize("preset", ["for_embeddings", "for_qa", "markdown_recursive", "semantic"])
def test_presets_match_jax(preset):
    ours, theirs = getattr(dp.DocumentProcessor, preset)(), getattr(jax_dp.DocumentProcessor, preset)()
    assert type(ours.chunker).__name__ == type(theirs.chunker).__name__
    assert vars(ours.chunker) == vars(theirs.chunker)
    text = (MD + "### Deeper\n\n" + "words and more words. " * 60) * 3
    assert ours.chunker.chunk(text) == theirs.chunker.chunk(text)


# -- the extra chunkers ---------------------------------------------------------------


@pytest.mark.parametrize(
    "inner",
    [
        lambda m: m.SimpleChunkerProvider(chunk_size=30, overlap=5),
        lambda m: m.MarkdownChunkerProvider(split_level=2, min_chunk_size=0),
        lambda m: m.MarkdownChunkerProvider(split_level=3, max_chunk_size=40),
    ],
    ids=["simple", "markdown", "markdown_small"],
)
@pytest.mark.parametrize("text", [MD, MD + "### Deep\n\nthird level\n\n# Second top\n\nagain\n", "no headings"])
def test_heading_path_wrapper_matches_jax(inner, text):
    import verbatim_rag_tpu.ingestion.chunkers as jax_chunkers
    import verbatim_rag_tpu_torch.ingestion.chunkers as chunkers

    ours = extra.HeadingPathWrapper(inner(chunkers)).chunk(text)
    assert ours == jax_extra.HeadingPathWrapper(inner(jax_chunkers)).chunk(text)
    if text == MD:
        assert any("Top > Sub" in enh for _, enh in ours if "sub body" in enh)


@pytest.mark.parametrize(
    "strategy,kwargs,text",
    [
        ("MARKDOWN", {}, MD),
        ("RECURSIVE", {"split_level": 1}, MD),
        ("FIXED", {"chunk_size": 40, "overlap": 5}, "x" * 100),
        ("SENTENCE", {"chunk_size": 100}, ("One sentence. Two sentence! Three? " * 30).strip()),
        ("SENTENCE", {}, "A. B."),
    ],
)
def test_chunk_with_strategy_matches_jax(strategy, kwargs, text):
    ours = extra.chunk_with_strategy(text, extra.ChunkingStrategy[strategy], **kwargs)
    assert ours == jax_extra.chunk_with_strategy(text, jax_extra.ChunkingStrategy[strategy], **kwargs)
    assert ours
    assert [s.value for s in extra.ChunkingStrategy] == [s.value for s in jax_extra.ChunkingStrategy]


def test_chunk_with_strategy_refuses_unknown_like_jax():
    for mod in (extra, jax_extra):
        with pytest.raises(ValueError, match="Unknown strategy"):
            mod.chunk_with_strategy("x", "bogus")


def test_chonkie_provider_is_import_gated_like_jax():
    import importlib.util

    assert importlib.util.find_spec("chonkie") is None  # not installed here
    messages = []
    for mod in (extra, jax_extra):
        with pytest.raises(ImportError, match="chonkie") as err:
            mod.ChonkieChunkerProvider()
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_chunkers_used_by_the_processor_are_the_copies():
    assert dataclasses.is_dataclass(dp.Document) == dataclasses.is_dataclass(jax_dp.Document)
    assert dp.DocumentProcessor().chunker.__class__ is MarkdownChunkerProvider
    assert dp.DocumentProcessor.semantic().chunker.__class__ is SimpleChunkerProvider
    assert JaxMarkdown is not MarkdownChunkerProvider and JaxSimple is not SimpleChunkerProvider
    assert json.dumps(vars(dp.DocumentProcessor().chunker), sort_keys=True) == json.dumps(
        vars(jax_dp.DocumentProcessor().chunker), sort_keys=True
    )
