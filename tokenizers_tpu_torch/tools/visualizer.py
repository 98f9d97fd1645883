"""HTML visualization of encodings; copy of `tokenizers_tpu.tools.visualizer`
(reference `bindings/python/py_src/tokenizers/tools/visualizer.py`): the
original text with a background per token and optional user annotations,
aligned through the encoding's char offsets.  IPython is imported only
when asked to display."""

from __future__ import annotations

import itertools
from typing import Callable, List, Optional

from ..tokenizer import Tokenizer


class Annotation:
    def __init__(self, start: int, end: int, label: str):
        self.start = start
        self.end = end
        self.label = label


AnnotationList = List[Annotation]

_CSS = """
<style>
.tok-viz { font-family: monospace; line-height: 1.8; }
.tok-viz .token { padding: 2px 1px; border-radius: 2px; }
.tok-viz .odd  { background: #ffd8b1; }
.tok-viz .even { background: #b3d9ff; }
.tok-viz .special { background: #d5a6f0; font-weight: bold; }
.tok-viz .unmapped { background: #eee; color: #999; }
.tok-viz .annotation { border-bottom: 3px solid; padding-bottom: 1px; }
.tok-viz .annotation-label { font-size: 0.7em; vertical-align: super; }
</style>
"""

_ANNOTATION_COLORS = [
    "#e6194b", "#3cb44b", "#4363d8", "#f58231", "#911eb4", "#46f0f0",
]


class EncodingVisualizer:
    """Build once with a tokenizer; call with text (and annotations) to get
    an HTML rendering. In notebooks the HTML is displayed directly when
    `default_to_notebook` is set."""

    def __init__(
        self,
        tokenizer: Tokenizer,
        default_to_notebook: bool = False,
        annotation_converter: Optional[Callable[[object], Annotation]] = None,
    ):
        self.tokenizer = tokenizer
        self.default_to_notebook = default_to_notebook
        self.annotation_converter = annotation_converter

    def __call__(
        self,
        text: str,
        annotations: Optional[AnnotationList] = None,
        default_to_notebook: Optional[bool] = None,
    ):
        annotations = annotations or []
        if self.annotation_converter is not None:
            annotations = [self.annotation_converter(a) for a in annotations]
        html = self.get_html(text, annotations)
        show = (
            self.default_to_notebook
            if default_to_notebook is None
            else default_to_notebook
        )
        if show:
            try:
                from IPython.display import HTML, display

                display(HTML(html))
                return None
            except ImportError:
                pass
        return html

    def get_html(self, text: str, annotations: AnnotationList) -> str:
        encoding = self.tokenizer.encode(text)
        # char -> token index map through char offsets
        char_token = [None] * len(text)
        for ti, (start, end) in enumerate(encoding.offsets):
            for ci in range(start, min(end, len(text))):
                if char_token[ci] is None:
                    char_token[ci] = ti
        # char -> annotation index
        char_anno = [None] * len(text)
        for ai, a in enumerate(annotations):
            for ci in range(a.start, min(a.end, len(text))):
                char_anno[ci] = ai

        spans = []
        for (tok, anno), group in itertools.groupby(
            range(len(text)), key=lambda ci: (char_token[ci], char_anno[ci])
        ):
            chunk = "".join(text[ci] for ci in group)
            chunk = (
                chunk.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")
            )
            classes = ["token"]
            if tok is None:
                classes.append("unmapped")
            elif encoding.special_tokens_mask[tok]:
                classes.append("special")
            else:
                classes.append("odd" if tok % 2 else "even")
            style = ""
            label = ""
            if anno is not None:
                color = _ANNOTATION_COLORS[anno % len(_ANNOTATION_COLORS)]
                classes.append("annotation")
                style = f' style="border-color: {color}"'
                label = (
                    f'<span class="annotation-label" style="color: {color}">'
                    f"{annotations[anno].label}</span>"
                )
            spans.append(
                f'<span class="{" ".join(classes)}"{style} '
                f'title="token {tok}">{chunk}</span>{label}'
            )
        return _CSS + '<div class="tok-viz">' + "".join(spans) + "</div>"

    @staticmethod
    def unk_token_regex(*_args, **_kwargs):  # parity stub with the reference
        return None
