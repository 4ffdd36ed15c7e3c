"""Report engine: physical report tree → HTML / plain text.

Port of ``photon_ml_tpu/diagnostics/reporting.py``, host numpy as there.

Reference parity: diagnostics/reporting/ — a logical report is transformed
into a physical tree (DocumentPhysicalReport → ChapterPhysicalReport →
SectionPhysicalReport → {SimpleText, BulletedList, NumberedList, Plot})
and rendered by a strategy (html/HTMLRenderStrategy.scala:23 emits XHTML
with numbered chapters/sections; text/StringRenderStrategy). The
reference rasterized XChart plots; here plots are inline SVG, dependency-
free and crisper.
"""

from __future__ import annotations

import dataclasses
import html as _html
from typing import List, Optional, Sequence, Tuple, Union


@dataclasses.dataclass
class SimpleText:
    text: str


@dataclasses.dataclass
class BulletedList:
    items: List[str]


@dataclasses.dataclass
class NumberedList:
    items: List[str]


@dataclasses.dataclass
class Table:
    headers: List[str]
    rows: List[Sequence]
    caption: str = ""


@dataclasses.dataclass
class Plot:
    """Line/scatter chart: multiple named series of (x, y) points."""

    title: str
    x_label: str
    y_label: str
    series: List[Tuple[str, Sequence[float], Sequence[float]]]
    width: int = 640
    height: int = 360


Item = Union[SimpleText, BulletedList, NumberedList, Table, Plot]


@dataclasses.dataclass
class Section:
    title: str
    items: List[Item] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Chapter:
    title: str
    sections: List[Section] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Document:
    title: str
    chapters: List[Chapter] = dataclasses.field(default_factory=list)


_SERIES_COLORS = ["#1f77b4", "#d62728", "#2ca02c", "#9467bd", "#ff7f0e", "#8c564b"]


def _svg_plot(p: Plot) -> str:
    """Minimal inline-SVG line chart with axes and a legend."""
    pad_l, pad_r, pad_t, pad_b = 60, 16, 28, 44
    iw = p.width - pad_l - pad_r
    ih = p.height - pad_t - pad_b
    xs = [x for _, sx, _ in p.series for x in sx]
    ys = [y for _, _, sy in p.series for y in sy if y == y]
    if not xs or not ys:
        return f"<p><em>{_html.escape(p.title)}: no data</em></p>"
    x0, x1 = min(xs), max(xs)
    y0, y1 = min(ys), max(ys)
    if x1 == x0:
        x1 = x0 + 1.0
    if y1 == y0:
        y1 = y0 + 1.0

    def X(v):
        return pad_l + (v - x0) / (x1 - x0) * iw

    def Y(v):
        return pad_t + ih - (v - y0) / (y1 - y0) * ih

    out = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{p.width}" '
        f'height="{p.height}" viewBox="0 0 {p.width} {p.height}" '
        'style="background:#fff;font-family:sans-serif">'
    ]
    out.append(
        f'<text x="{p.width/2:.0f}" y="16" text-anchor="middle" '
        f'font-size="13" font-weight="bold">{_html.escape(p.title)}</text>'
    )
    # axes
    out.append(
        f'<line x1="{pad_l}" y1="{pad_t}" x2="{pad_l}" y2="{pad_t+ih}" '
        'stroke="#333"/>'
        f'<line x1="{pad_l}" y1="{pad_t+ih}" x2="{pad_l+iw}" y2="{pad_t+ih}" '
        'stroke="#333"/>'
    )
    for i in range(5):
        fx = x0 + (x1 - x0) * i / 4
        fy = y0 + (y1 - y0) * i / 4
        out.append(
            f'<text x="{X(fx):.1f}" y="{pad_t+ih+16}" text-anchor="middle" '
            f'font-size="10">{fx:.3g}</text>'
            f'<text x="{pad_l-6}" y="{Y(fy)+3:.1f}" text-anchor="end" '
            f'font-size="10">{fy:.3g}</text>'
        )
    out.append(
        f'<text x="{pad_l+iw/2:.0f}" y="{p.height-6}" text-anchor="middle" '
        f'font-size="11">{_html.escape(p.x_label)}</text>'
        f'<text x="14" y="{pad_t+ih/2:.0f}" text-anchor="middle" '
        f'font-size="11" transform="rotate(-90 14 {pad_t+ih/2:.0f})">'
        f'{_html.escape(p.y_label)}</text>'
    )
    for si, (name, sx, sy) in enumerate(p.series):
        color = _SERIES_COLORS[si % len(_SERIES_COLORS)]
        pts = [
            (X(x), Y(y)) for x, y in zip(sx, sy) if y == y
        ]
        if len(pts) > 1:
            d = " ".join(f"{x:.1f},{y:.1f}" for x, y in pts)
            out.append(
                f'<polyline points="{d}" fill="none" stroke="{color}" '
                'stroke-width="1.5"/>'
            )
        for x, y in pts:
            out.append(f'<circle cx="{x:.1f}" cy="{y:.1f}" r="2.5" fill="{color}"/>')
        out.append(
            f'<rect x="{pad_l+iw-130}" y="{pad_t+6+14*si}" width="10" '
            f'height="10" fill="{color}"/>'
            f'<text x="{pad_l+iw-116}" y="{pad_t+15+14*si}" font-size="10">'
            f'{_html.escape(name)}</text>'
        )
    out.append("</svg>")
    return "".join(out)


def _render_item_html(item: Item) -> str:
    if isinstance(item, SimpleText):
        return f"<p>{_html.escape(item.text)}</p>"
    if isinstance(item, BulletedList):
        inner = "".join(f"<li>{_html.escape(i)}</li>" for i in item.items)
        return f"<ul>{inner}</ul>"
    if isinstance(item, NumberedList):
        inner = "".join(f"<li>{_html.escape(i)}</li>" for i in item.items)
        return f"<ol>{inner}</ol>"
    if isinstance(item, Table):
        head = "".join(f"<th>{_html.escape(h)}</th>" for h in item.headers)
        body = "".join(
            "<tr>" + "".join(f"<td>{_html.escape(str(c))}</td>" for c in row) + "</tr>"
            for row in item.rows
        )
        cap = f"<caption>{_html.escape(item.caption)}</caption>" if item.caption else ""
        return (
            f'<table border="1" cellspacing="0" cellpadding="4">{cap}'
            f"<thead><tr>{head}</tr></thead><tbody>{body}</tbody></table>"
        )
    if isinstance(item, Plot):
        return _svg_plot(item)
    raise TypeError(f"unknown report item: {type(item)}")


def render_html(doc: Document) -> str:
    """Standalone HTML document with numbered chapters/sections (reference
    html/DocumentToHTMLRenderer + NumberingContext)."""
    parts = [
        "<!DOCTYPE html>",
        '<html><head><meta charset="utf-8"/>',
        f"<title>{_html.escape(doc.title)}</title>",
        "<style>body{font-family:sans-serif;margin:2em;max-width:60em}"
        "table{border-collapse:collapse;margin:1em 0}"
        "h1{border-bottom:2px solid #333}</style>",
        "</head><body>",
        f"<h1>{_html.escape(doc.title)}</h1>",
    ]
    for ci, chapter in enumerate(doc.chapters, 1):
        parts.append(f"<h2>{ci}. {_html.escape(chapter.title)}</h2>")
        for si, section in enumerate(chapter.sections, 1):
            parts.append(f"<h3>{ci}.{si}. {_html.escape(section.title)}</h3>")
            parts.extend(_render_item_html(item) for item in section.items)
    parts.append("</body></html>")
    return "\n".join(parts)


def render_text(doc: Document) -> str:
    """Plain-text rendering (reference text/StringRenderStrategy)."""
    lines = [doc.title, "=" * len(doc.title)]
    for ci, chapter in enumerate(doc.chapters, 1):
        lines.append(f"\n{ci}. {chapter.title}")
        for si, section in enumerate(chapter.sections, 1):
            lines.append(f"\n{ci}.{si}. {section.title}")
            for item in section.items:
                if isinstance(item, SimpleText):
                    lines.append(item.text)
                elif isinstance(item, (BulletedList, NumberedList)):
                    mark = "-" if isinstance(item, BulletedList) else "#"
                    lines.extend(f"  {mark} {i}" for i in item.items)
                elif isinstance(item, Table):
                    lines.append("  " + " | ".join(item.headers))
                    lines.extend(
                        "  " + " | ".join(str(c) for c in row) for row in item.rows
                    )
                elif isinstance(item, Plot):
                    lines.append(f"  [plot: {item.title}]")
    return "\n".join(lines)
