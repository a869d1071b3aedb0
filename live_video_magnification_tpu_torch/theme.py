"""Design-token theming for the tk GUI — the reference's Theme system.

The counterpart of the reference package's ``theme.py``, host code with no
device work. Reproduces reference src/ui/Theme.{hpp,cpp}: a ThemePalette of
named tokens (every color in the UI comes from here, Theme.hpp:13-28), the
8pt spacing grid + radii (metrics, Theme.hpp:30-38), dark/light palettes
with the same published values (Theme.cpp:227-261), `mix` (Theme.hpp:43-52),
follow-the-OS until the user pins a scheme (Theme.hpp:64-68; nothing
persisted), and a runtime toggle. Qt's QSS generation maps to a pure
`style_map` consumed by `apply()` via ttk.Style — the mapping itself is
headless-testable; `apply` imports tkinter inside the call, so the module
imports where tk is missing.

Scheme resolution order (resolve_scheme): explicit LVMT_THEME=dark|light →
a dark/light hint in GTK_THEME / COLORFGBG → Dark (the reference's fallback
when the OS gives no answer, Theme.hpp:61).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

DARK = "dark"
LIGHT = "light"

# 8pt spacing grid and corner radii (Theme.hpp:31-37); tk has no rounded
# corners but the paddings derive from the same scale.
SPACE1, SPACE2, SPACE3, SPACE4, SPACE5 = 4, 8, 12, 16, 24
RADIUS, RADIUS_SMALL = 8, 6


@dataclasses.dataclass(frozen=True)
class ThemePalette:
    """Named color tokens (Theme.hpp:13-28)."""

    bg: str        # window / canvas chrome ground
    surface: str   # toolbar / inspector panels
    surface2: str  # transport bar, sunken rows
    raised: str    # default buttons
    line: str      # hairline borders / separators
    text: str
    dim: str       # secondary text / labels
    faint: str     # tertiary text / disabled
    field: str     # text-entry background
    accent: str
    accent2: str   # gradient partner — gradients only, never flat chrome
    accent_ink: str  # text/icon color on top of an accent fill
    ok: str
    danger: str


def palette(scheme: str) -> ThemePalette:
    """The reference's published token values (Theme.cpp:227-261)."""
    if scheme == DARK:
        return ThemePalette(
            bg="#15110D", surface="#211A14", surface2="#29211A",
            raised="#2C241C", line="#382E25", text="#F3ECE3", dim="#A99A8B",
            faint="#6E6359", field="#0F0C09", accent="#F4A23C",
            accent2="#F0476E", accent_ink="#2A1505", ok="#8FCB8A",
            danger="#F2606B",
        )
    return ThemePalette(
        bg="#EEF0F2", surface="#FFFFFF", surface2="#F4F6F8", raised="#FFFFFF",
        line="#D8DCE0", text="#1E1B17", dim="#6B6A66", faint="#9DA0A6",
        field="#FFFFFF", accent="#B8521C", accent2="#B01E5B",
        accent_ink="#FFFFFF", ok="#2E9E63", danger="#C8473E",
    )


def mix(a: str, b: str, t: float) -> str:
    """Linear blend of two #RRGGBB colors, t=0 -> a, t=1 -> b (Theme.hpp:43)."""
    t = min(max(t, 0.0), 1.0)

    def chan(i):
        av = int(a[1 + 2 * i : 3 + 2 * i], 16)
        bv = int(b[1 + 2 * i : 3 + 2 * i], 16)
        return int(av * (1.0 - t) + bv * t)

    return "#{:02X}{:02X}{:02X}".format(chan(0), chan(1), chan(2))


def resolve_scheme(env: Optional[Dict[str, str]] = None) -> str:
    """LVMT_THEME pin → OS hint (GTK_THEME/COLORFGBG) → Dark fallback."""
    env = os.environ if env is None else env
    pin = env.get("LVMT_THEME", "").lower()
    if pin in (DARK, LIGHT):
        return pin
    gtk = env.get("GTK_THEME", "").lower()
    if "dark" in gtk:
        return DARK
    if gtk:
        return LIGHT
    fgbg = env.get("COLORFGBG", "")
    if fgbg:
        try:  # "fg;bg" — light background numbers mean a light terminal
            bg_code = int(fgbg.split(";")[-1])
            return LIGHT if bg_code in (7, 15) else DARK
        except ValueError:
            pass
    return DARK  # the reference falls back to Dark when the OS gives nothing


def toggled(scheme: str) -> str:
    return LIGHT if scheme == DARK else DARK


def style_map(p: ThemePalette) -> Dict[str, Dict[str, object]]:
    """ttk style configuration derived from the tokens — the QSS-template
    analogue (Theme.cpp:263-281), pure and headless-testable. Keys are ttk
    style names; values are the kwargs for ttk.Style().configure()."""
    pad = (SPACE2, SPACE1)
    return {
        ".": dict(background=p.surface, foreground=p.text,
                  fieldbackground=p.field, bordercolor=p.line,
                  lightcolor=p.surface, darkcolor=p.surface,
                  troughcolor=p.line, arrowcolor=p.dim,
                  insertcolor=p.text, selectbackground=p.accent,
                  selectforeground=p.accent_ink, focuscolor=p.accent),
        "TFrame": dict(background=p.surface),
        "TLabel": dict(background=p.surface, foreground=p.text),
        "Dim.TLabel": dict(background=p.surface, foreground=p.dim),
        "TButton": dict(background=p.raised, foreground=p.text, padding=pad),
        "Accent.TButton": dict(background=p.accent, foreground=p.accent_ink,
                               padding=pad),
        "TCheckbutton": dict(background=p.surface, foreground=p.text),
        "TRadiobutton": dict(background=p.surface, foreground=p.text),
        "TMenubutton": dict(background=p.raised, foreground=p.text),
        "TCombobox": dict(fieldbackground=p.field, background=p.raised,
                          foreground=p.text, arrowcolor=p.dim),
        "TEntry": dict(fieldbackground=p.field, foreground=p.text,
                       insertcolor=p.text),
        "TSpinbox": dict(fieldbackground=p.field, foreground=p.text,
                         arrowcolor=p.dim, insertcolor=p.text),
        "Horizontal.TScale": dict(background=p.surface, troughcolor=p.line),
        "Horizontal.TProgressbar": dict(background=p.accent,
                                        troughcolor=p.field),
        "TNotebook": dict(background=p.surface),
        "TSeparator": dict(background=p.line),
        "Treeview": dict(background=p.field, fieldbackground=p.field,
                         foreground=p.text),
    }


def widget_defaults(p: ThemePalette) -> Dict[str, str]:
    """option_add defaults for plain-tk widgets (Canvas, Listbox, Toplevel)."""
    return {
        "*background": p.surface,
        "*foreground": p.text,
        "*Canvas.background": p.bg,
        "*Listbox.background": p.field,
        "*Listbox.foreground": p.text,
        "*Listbox.selectBackground": p.accent,
        "*Listbox.selectForeground": p.accent_ink,
        "*Entry.background": p.field,
        "*Entry.foreground": p.text,
        "*Entry.insertBackground": p.text,
        "*Text.background": p.field,
        "*Text.foreground": p.text,
    }


class ThemeState:
    """Follow-the-OS until pinned (Theme.hpp:64-68); nothing persisted."""

    def __init__(self, env: Optional[Dict[str, str]] = None):
        self._pinned: Optional[str] = None
        self._env = env

    @property
    def scheme(self) -> str:
        return self._pinned or resolve_scheme(self._env)

    @property
    def following_system(self) -> bool:
        return self._pinned is None

    def toggle(self) -> str:
        self._pinned = toggled(self.scheme)
        return self._pinned


def apply(root, scheme: str) -> ThemePalette:
    """Apply the palette to a live tk root: ttk styles + plain-tk defaults.
    Returns the palette so callers can color custom canvases."""
    from tkinter import ttk

    p = palette(scheme)
    style = ttk.Style(root)
    if "clam" in style.theme_names():  # flat base, like Fusion for Qt
        style.theme_use("clam")
    for name, cfg in style_map(p).items():
        style.configure(name, **cfg)
    style.map("TButton", background=[("active", mix(p.raised, p.accent, 0.2))])
    style.map("Accent.TButton",
              background=[("active", mix(p.accent, p.text, 0.15))])
    style.map("TCombobox", fieldbackground=[("readonly", p.field)])
    for pattern, value in widget_defaults(p).items():
        root.option_add(pattern, value)
    root.configure(bg=p.bg)
    return p
