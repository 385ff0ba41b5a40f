"""A small raster plotter on numpy: the port's figures, written as PNG
with no plotting package.

The JAX package draws its training figures with matplotlib
(``scripts/plot_training_progress.py``), which the card's machine does not
have. This module draws the same figures — panels in a grid, axes with
ticks (linear or log y), lines and markers, legends, titles, labels and
text — into an (H, W, 3) uint8 canvas and saves it through
``utils/image.py::save_png``. Its :class:`Axes` takes the subset of
matplotlib's calls those figures make (``plot``, ``semilogy``,
``set_title``, ``set_xlabel``, ``set_ylabel``, ``set_yscale``,
``set_ylim``, ``legend``, ``grid``, ``axis("off")``, ``text``), so the
figure code reads as JAX's. Text comes from a 5x7 bitmap font embedded
below (printable ASCII; other characters draw as ``?``), scaled by whole
pixels.

Drawing is deferred: an axes records its series and settings, and
:meth:`Figure.render` lays out every panel, then draws. After
:meth:`Figure.render`, :meth:`Axes.to_pixel` maps data to the canvas's
(column, row), where each series' points were drawn.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

# 5x7 glyphs of ASCII 32-126, 7 rows each as two hex digits (bit 4 the
# leftmost column).
_FONT = (
    "00000000000000" "04040404000004" "0a0a0a00000000" "0a0a1f0a1f0a0a"
    "040f140e051e04" "18190204081303" "0c12140815120d" "0c040800000000"
    "02040808080402" "08040202020408" "0004150e150400" "0004041f040400"
    "000000000c0408" "0000001f000000" "00000000000c0c" "00010204081000"
    "0e11131519110e" "040c040404040e" "0e11010204081f" "1f02040201110e"
    "02060a121f0202" "1f101e0101110e" "0608101e11110e" "1f010204080808"
    "0e11110e11110e" "0e11110f01020c" "000c0c000c0c00" "000c0c000c0408"
    "02040810080402" "00001f001f0000" "08040201020408" "0e110102040004"
    "0e11010d15150e" "0e1111111f1111" "1e11111e11111e" "0e11101010110e"
    "1c12111111121c" "1f10101e10101f" "1f10101e101010" "0e11101711110f"
    "1111111f111111" "0e04040404040e" "0702020202120c" "11121418141211"
    "1010101010101f" "111b1515111111" "11111915131111" "0e11111111110e"
    "1e11111e101010" "0e11111115120d" "1e11111e141211" "0f10100e01011e"
    "1f040404040404" "1111111111110e" "11111111110a04" "1111111515150a"
    "11110a040a1111" "1111110a040404" "1f01020408101f" "0e08080808080e"
    "00100804020100" "0e02020202020e" "040a1100000000" "0000000000001f"
    "08040200000000" "00000e010f110f" "1010161911111e" "00000e1010110e"
    "01010d1311110f" "00000e111f100e" "0609081c080808" "000f11110f010e"
    "10101619111111" "04000c0404040e" "0200060202120c" "10101214181412"
    "0c04040404040e" "00001a15151111" "00001619111111" "00000e1111110e"
    "00001e111e1010" "00000d130f0101" "00001619101010" "00000e100e011e"
    "08081c08080906" "0000111111130d" "00001111110a04" "0000111115150a"
    "0000110a040a11" "000011110f010e" "00001f0204081f" "02040408040402"
    "04040404040404" "08040402040408" "00000815020000"
)
_GLYPH_W, _GLYPH_H = 5, 7

# matplotlib's tab10 colours, in its default cycle order.
_COLORS = {
    "tab:blue": (31, 119, 180), "tab:orange": (255, 127, 14),
    "tab:green": (44, 160, 44), "tab:red": (214, 39, 40),
    "tab:purple": (148, 103, 189), "tab:brown": (140, 86, 75),
    "tab:pink": (227, 119, 194), "tab:gray": (127, 127, 127),
    "tab:olive": (188, 189, 34), "tab:cyan": (23, 190, 207),
}
_CYCLE = list(_COLORS.values())
_BLACK, _GRID, _WHITE = (0, 0, 0), (225, 225, 225), (255, 255, 255)


def _glyph(ch: str) -> np.ndarray:
    """The (7, 5) bool bitmap of one character."""
    code = ord(ch) if 32 <= ord(ch) <= 126 else ord("?")
    hexes = _FONT[(code - 32) * 14:(code - 31) * 14]
    rows = [int(hexes[2 * i:2 * i + 2], 16) for i in range(_GLYPH_H)]
    return np.array([[(r >> (4 - c)) & 1 for c in range(_GLYPH_W)]
                     for r in rows], bool)


def text_mask(s: str, scale: int = 1) -> np.ndarray:
    """The bool bitmap of a line of text: glyphs 6 columns apart, each
    pixel ``scale`` x ``scale``."""
    if not s:
        return np.zeros((_GLYPH_H * scale, 0), bool)
    cells = [np.pad(_glyph(ch), ((0, 0), (0, 1))) for ch in s]
    mask = np.concatenate(cells, axis=1)[:, :-1]
    return np.kron(mask, np.ones((scale, scale), bool)).astype(bool)


class Canvas:
    """An (H, W, 3) uint8 image, white, with clipped drawing."""

    def __init__(self, width: int, height: int):
        self.px = np.full((height, width, 3), 255, np.uint8)

    @property
    def shape(self) -> Tuple[int, int]:
        return self.px.shape[:2]

    def fill(self, x0, y0, x1, y1, color) -> None:
        """The rectangle of columns [x0, x1) and rows [y0, y1)."""
        x0, x1 = max(int(x0), 0), min(int(x1), self.shape[1])
        y0, y1 = max(int(y0), 0), min(int(y1), self.shape[0])
        if x0 < x1 and y0 < y1:
            self.px[y0:y1, x0:x1] = color

    def mask(self, m: np.ndarray, x: int, y: int, color) -> None:
        """Paint the bool mask ``m`` with its top-left at (x, y)."""
        h, w = m.shape
        x0, y0 = max(x, 0), max(y, 0)
        x1, y1 = min(x + w, self.shape[1]), min(y + h, self.shape[0])
        if x0 >= x1 or y0 >= y1:
            return
        sub = m[y0 - y:y1 - y, x0 - x:x1 - x]
        self.px[y0:y1, x0:x1][sub] = color

    def text(self, s: str, x: int, y: int, scale: int = 1, color=_BLACK,
             anchor: str = "lt", vertical: bool = False) -> None:
        """One line of text at (x, y); ``anchor``: horizontal l / c / r
        and vertical t / m / b of its box; ``vertical``: rotated a quarter
        turn anticlockwise (a y label)."""
        m = text_mask(s, scale)
        if vertical:
            m = np.rot90(m)
        h, w = m.shape
        x -= {"l": 0, "c": w // 2, "r": w}[anchor[0]]
        y -= {"t": 0, "m": h // 2, "b": h}[anchor[1]]
        self.mask(m, int(x), int(y), color)

    def line(self, x0, y0, x1, y1, color, width: int = 1,
             clip=None) -> None:
        """A straight segment between two (sub-pixel) points, ``width``
        pixels wide, clipped to ``clip`` (x0, y0, x1, y1)."""
        n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
        t = np.linspace(0.0, 1.0, n + 1)
        xs = np.rint(x0 + (x1 - x0) * t).astype(np.int64)
        ys = np.rint(y0 + (y1 - y0) * t).astype(np.int64)
        self.points(xs, ys, color, width, clip)

    def points(self, xs, ys, color, size: int = 1, clip=None) -> None:
        """Squares of ``size`` pixels centred on integer points."""
        cx0, cy0, cx1, cy1 = clip or (0, 0, self.shape[1], self.shape[0])
        lo = -(size // 2)
        for dx in range(lo, lo + size):
            for dy in range(lo, lo + size):
                x, y = np.asarray(xs) + dx, np.asarray(ys) + dy
                keep = (x >= cx0) & (x < cx1) & (y >= cy0) & (y < cy1)
                self.px[y[keep], x[keep]] = color


def _color(c, i: int):
    if c is None:
        return _CYCLE[i % len(_CYCLE)]
    if isinstance(c, str):
        return _COLORS.get(c, _BLACK)
    return tuple(int(v) for v in c)


def _parse_fmt(fmt: str):
    """matplotlib's format string: (marker or None, whether a line)."""
    marker = next((m for m in "os^" if m in fmt), None)
    return marker, "-" in fmt or not fmt


def nice_ticks(lo: float, hi: float, n: int = 5) -> List[float]:
    """About ``n`` round values (1, 2, 5 x 10^k steps) covering [lo, hi]."""
    if not (math.isfinite(lo) and math.isfinite(hi)) or hi <= lo:
        return [lo]
    raw = (hi - lo) / max(n, 1)
    mag = 10.0 ** math.floor(math.log10(raw))
    step = next(m * mag for m in (1, 2, 5, 10) if m * mag >= raw)
    first = math.ceil(lo / step - 1e-9) * step
    return [round(first + i * step, 12)
            for i in range(int((hi - first) / step + 1e-9) + 1)]


def log_ticks(lo: float, hi: float) -> List[float]:
    """log10 tick positions over [lo, hi] (log10 units): the decades,
    and 2 x and 5 x each decade where fewer than two decades fall."""
    decades = list(range(math.ceil(lo), math.floor(hi) + 1))
    if len(decades) >= 2:
        return [float(k) for k in decades]
    cands = [k + math.log10(m) for k in range(math.floor(lo),
                                              math.ceil(hi) + 1)
             for m in (1, 2, 5)]
    return [t for t in cands if lo <= t <= hi]


def _fmt_tick(v: float) -> str:
    if v == 0:
        return "0"
    if abs(v) >= 1e5 or abs(v) < 1e-3:
        return f"{v:.0e}".replace("e-0", "e-").replace("e+0", "e")
    return f"{v:g}"


class Axes:
    """One panel: the series and settings of matplotlib's calls, drawn by
    :meth:`Figure.render` into the ``cells`` (rows, cols, first, last) of
    its figure's grid."""

    def __init__(self, cells):
        self.cells = cells
        self.box = None     # (x0, y0, x1, y1) on the canvas, once drawn
        self.series = []    # (x, y, color, marker, line, label, ms, lw)
        self.texts = []
        self.title = self.xlabel = self.ylabel = ""
        self.yscale = "linear"
        self.ylim = None
        self.show_legend = self.show_grid = False
        self.visible = True
        self.area = None    # the data area (x0, y0, x1, y1), once drawn
        self.xlim_data = self.ylim_data = None

    # -- matplotlib's calls ---------------------------------------------- #
    def plot(self, *args, label: Optional[str] = None, color=None,
             ms: float = 4, lw: float = 1.5):
        """``plot(y)``, ``plot(x, y)`` or ``plot(x, y, fmt)``."""
        fmt = args[-1] if args and isinstance(args[-1], str) else "-"
        args = [a for a in args if not isinstance(a, str)]
        y = np.asarray(args[-1], np.float64).reshape(-1)
        x = (np.asarray(args[0], np.float64).reshape(-1) if len(args) > 1
             else np.arange(len(y), dtype=np.float64))
        n = min(len(x), len(y))
        marker, line = _parse_fmt(fmt)
        self.series.append((x[:n], y[:n], _color(color, len(self.series)),
                            marker, line, label, ms, lw))

    def semilogy(self, *args, **kw):
        self.plot(*args, **kw)
        self.yscale = "log"

    def set_title(self, s: str):
        self.title = str(s)

    def set_xlabel(self, s: str):
        self.xlabel = str(s)

    def set_ylabel(self, s: str):
        self.ylabel = str(s)

    def set_yscale(self, scale: str):
        self.yscale = scale

    def set_ylim(self, lo, hi):
        self.ylim = (float(lo), float(hi))

    def legend(self):
        self.show_legend = True

    def grid(self, on: bool = True):
        self.show_grid = bool(on)

    def axis(self, what: str):
        if what == "off":
            self.visible = False

    def text(self, x: float, y: float, s: str):
        """Text at axes fraction (x, y) from the bottom left, top-anchored
        lines (the summary panel's ``va="top"``)."""
        self.texts.append((float(x), float(y), str(s)))

    # -- layout and drawing ---------------------------------------------- #
    def _ty(self, y):
        y = np.asarray(y, np.float64)
        if self.yscale == "log":
            with np.errstate(divide="ignore", invalid="ignore"):
                return np.where(y > 0, np.log10(np.where(y > 0, y, 1.0)),
                                np.nan)
        return y

    def _limits(self):
        xs = [s[0] for s in self.series if len(s[0])]
        ys = [self._ty(s[1]) for s in self.series if len(s[1])]
        x = np.concatenate(xs) if xs else np.zeros(0)
        y = np.concatenate(ys) if ys else np.zeros(0)
        x, y = x[np.isfinite(x)], y[np.isfinite(y)]
        xlo, xhi = (float(x.min()), float(x.max())) if len(x) else (0.0, 1.0)
        ylo, yhi = (float(y.min()), float(y.max())) if len(y) else (0.0, 1.0)
        if self.ylim is not None:
            ylo, yhi = (float(v) for v in self._ty(self.ylim))
        if xhi <= xlo:
            xlo, xhi = xlo - 0.5, xhi + 0.5
        if yhi <= ylo:
            pad = 0.5 if self.yscale == "log" else max(abs(ylo) * 0.05, 0.5)
            ylo, yhi = ylo - pad, yhi + pad
        if self.ylim is None:   # matplotlib's 5% margins
            my, mx = 0.05 * (yhi - ylo), 0.05 * (xhi - xlo)
            ylo, yhi, xlo, xhi = ylo - my, yhi + my, xlo - mx, xhi + mx
        return (xlo, xhi), (ylo, yhi)

    def _legend_corner(self, w: int, h: int, gap: int):
        """The top-left of a w x h legend: the corner of the data area
        (upper right first, as matplotlib's "best" prefers) over the
        fewest drawn points."""
        x0, y0, x1, y1 = self.area
        pts = [self.to_pixel(x, y) for x, y, *_ in self.series]
        best = None
        for lx, ly in ((x1 - w - gap, y0 + gap), (x0 + gap, y0 + gap),
                       (x1 - w - gap, y1 - h - gap), (x0 + gap, y1 - h - gap)):
            n = sum(int(np.sum((px >= lx) & (px < lx + w) & (py >= ly)
                               & (py < ly + h))) for px, py in pts)
            if best is None or n < best[0]:
                best = (n, lx, ly)
        return best[1], best[2]

    def to_pixel(self, x, y):
        """Data -> canvas (column, row) arrays, after :meth:`Figure.render`
        (log y maps log10; a non-positive y maps to NaN)."""
        (xlo, xhi), (ylo, yhi) = self.xlim_data, self.ylim_data
        x0, y0, x1, y1 = self.area
        px = x0 + (np.asarray(x, np.float64) - xlo) / (xhi - xlo) * (x1 - 1
                                                                     - x0)
        py = (y1 - 1) - (self._ty(y) - ylo) / (yhi - ylo) * (y1 - 1 - y0)
        return px, py

    def draw(self, canvas: Canvas, scale: int) -> None:
        ch, gap = _GLYPH_H * scale, 2 * scale
        bx0, by0, bx1, by1 = self.box
        if self.title:
            canvas.text(self.title, (bx0 + bx1) // 2, by0, scale,
                        anchor="ct")
        if not self.visible:
            top = by0 + ch + 2 * gap
            for fx, fy, s in self.texts:
                y = top + int((1.0 - fy) * (by1 - top))
                for i, line in enumerate(s.split("\n")):
                    canvas.text(line, bx0 + int(fx * (bx1 - bx0)),
                                y + i * (ch + 2 * gap), scale)
            return
        (xlo, xhi), (ylo, yhi) = self._limits()
        yticks = nice_ticks(ylo, yhi) if self.yscale != "log" else \
            log_ticks(ylo, yhi)
        labels = [_fmt_tick(10.0 ** t if self.yscale == "log" else t)
                  for t in yticks]
        tick_w = max([len(s) for s in labels] + [1]) * 6 * scale
        left = bx0 + tick_w + 2 * gap + (ch + 3 * gap if self.ylabel else 0)
        top = by0 + (ch + 2 * gap if self.title else gap)
        bottom = by1 - ch - 3 * gap - (ch + 2 * gap if self.xlabel else 0)
        right = bx1 - 2 * gap
        self.area = (left, top, right, bottom)
        self.xlim_data, self.ylim_data = (xlo, xhi), (ylo, yhi)
        xticks = nice_ticks(xlo, xhi)
        for t, s in zip(yticks, labels):
            _, py = self.to_pixel([xlo], [10.0 ** t if self.yscale == "log"
                                          else t])
            py = int(round(float(py[0])))
            if not top <= py < bottom:
                continue
            if self.show_grid:
                canvas.fill(left, py, right, py + 1, _GRID)
            canvas.fill(left - gap, py, left, py + 1, _BLACK)
            canvas.text(s, left - gap - scale, py, scale, anchor="rm")
        for t in xticks:
            px, _ = self.to_pixel([t], [1.0])
            px = int(round(float(px[0])))
            if not left <= px < right:
                continue
            if self.show_grid:
                canvas.fill(px, top, px + 1, bottom, _GRID)
            canvas.fill(px, bottom, px + 1, bottom + gap, _BLACK)
            canvas.text(_fmt_tick(t), px, bottom + gap + scale, scale,
                        anchor="ct")
        clip = (left, top, right, bottom)
        for x, y, color, marker, line, _, ms, lw in self.series:
            px, py = self.to_pixel(x, y)
            ok = np.isfinite(px) & np.isfinite(py)
            width = max(1, int(round(lw * scale / 2)))
            if line:
                for i in range(len(px) - 1):
                    if ok[i] and ok[i + 1]:
                        canvas.line(px[i], py[i], px[i + 1], py[i + 1],
                                    color, width, clip)
            if marker or len(px) == 1:
                size = max(3, int(round(ms * scale / 2)) | 1)
                canvas.points(np.rint(px[ok]).astype(np.int64),
                              np.rint(py[ok]).astype(np.int64), color, size,
                              clip)
        # The frame, over the data.
        canvas.fill(left, top, right, top + 1, _BLACK)
        canvas.fill(left, bottom - 1, right, bottom, _BLACK)
        canvas.fill(left, top, left + 1, bottom, _BLACK)
        canvas.fill(right - 1, top, right, bottom, _BLACK)
        if self.xlabel:
            canvas.text(self.xlabel, (left + right) // 2, by1 - gap, scale,
                        anchor="cb")
        if self.ylabel:
            canvas.text(self.ylabel, bx0 + gap, (top + bottom) // 2, scale,
                        anchor="lm", vertical=True)
        labelled = [s for s in self.series if s[5]]
        if self.show_legend and labelled:
            w = max(len(s[5]) for s in labelled) * 6 * scale + 8 * gap
            h = len(labelled) * (ch + gap) + gap
            lx, ly = self._legend_corner(w, h, gap)
            canvas.fill(lx, ly, lx + w, ly + h, _WHITE)
            canvas.fill(lx, ly, lx + w, ly + 1, _GRID)
            canvas.fill(lx, ly + h - 1, lx + w, ly + h, _GRID)
            for i, s in enumerate(labelled):
                yy = ly + gap + i * (ch + gap) + ch // 2
                canvas.fill(lx + gap, yy - scale // 2, lx + 5 * gap,
                            yy + max(1, scale // 2), s[2])
                canvas.text(s[5], lx + 6 * gap, yy, scale, anchor="lm")


class Figure:
    """A ``width`` x ``height`` pixel figure of panels; text at ``scale``
    pixels a font pixel."""

    def __init__(self, width: int, height: int, scale: int = 2):
        self.width, self.height, self.scale = int(width), int(height), scale
        self.axes: List[Axes] = []
        self.title = ""
        self.canvas: Optional[Canvas] = None

    def _top(self) -> int:
        return (_GLYPH_H * self.scale + 6 * self.scale) if self.title else 0

    def subplots(self, rows: int, cols: int) -> List[Axes]:
        """``rows`` x ``cols`` equal panels, row by row."""
        return [self.subplot(rows, cols, i + 1)
                for i in range(rows * cols)]

    def subplot(self, rows: int, cols: int, index) -> Axes:
        """matplotlib's ``subplot(rows, cols, index)``; ``index`` 1-based,
        or a (first, last) pair of cells spanned."""
        ax = Axes((rows, cols) + (index if isinstance(index, tuple)
                                  else (index, index)))
        self.axes.append(ax)
        return ax

    def _box(self, rows, cols, first, last):
        """The pixel box of the cells ``first``-``last`` of the grid."""
        pad = 6 * self.scale
        top = self._top()
        cw = (self.width - pad) / cols
        rh = (self.height - top - pad) / rows
        r0, c0 = divmod(first - 1, cols)
        r1, c1 = divmod(last - 1, cols)
        return tuple(int(v) for v in (pad + c0 * cw, top + pad + r0 * rh,
                                      (c1 + 1) * cw, top + (r1 + 1) * rh))

    def suptitle(self, s: str):
        self.title = str(s)

    def render(self) -> np.ndarray:
        """Every panel drawn: the (H, W, 3) uint8 pixels."""
        self.canvas = Canvas(self.width, self.height)
        if self.title:
            self.canvas.text(self.title, self.width // 2, 3 * self.scale,
                             self.scale, anchor="ct")
        for ax in self.axes:
            ax.box = self._box(*ax.cells)
            ax.draw(self.canvas, self.scale)
        return self.canvas.px

    def savefig(self, path: str) -> str:
        from nerfmlp_torch.utils.image import save_png

        save_png(path, self.render())
        return path


def subplots(rows: int, cols: int, width: int, height: int,
             scale: int = 2) -> Tuple[Figure, Sequence[Axes]]:
    """A figure of ``rows`` x ``cols`` panels (``plt.subplots``)."""
    fig = Figure(width, height, scale)
    return fig, fig.subplots(rows, cols)
