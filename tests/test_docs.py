"""Docs guards for README.md and ARCHITECTURE.md.

A speed the docs quote must say which card it was measured on, stale
figures from earlier rounds must never come back, and test counts are not
hard-coded (they drift).
"""

import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

# figures flagged as stale in earlier reviews; they must never reappear
FORBIDDEN = [
    "1052 Mpixel/s", "814 Mpixel/s", "1052 Mpix/s", "814 Mpix/s",
    "156 ms", "129 tests", "3956 Mpix", "1791 Mpix", "0.76 ms",
]


def _md_texts():
    out = {}
    for name in ("README.md", "ARCHITECTURE.md"):
        path = ROOT / name
        if path.exists():
            out[name] = re.sub(r"<!--.*?-->", "", path.read_text())
    return out


@pytest.mark.parametrize("doc", ["README.md", "ARCHITECTURE.md"])
def test_quoted_speeds_name_the_card(doc):
    """Every 'N Mpix/s' figure sits in a paragraph that names the card it
    was measured on."""
    text = _md_texts()[doc]
    for para in re.split(r"\n\s*\n", text):
        if re.search(r"\d\s*(Mpix|Mpixel|Gpix|Gpixel)/s", para):
            assert "H100" in para, (
                f"{doc} quotes a speed without naming the card: {para[:200]!r}"
            )


def test_no_stale_round1_numbers_anywhere():
    for name, text in _md_texts().items():
        for bad in FORBIDDEN:
            assert bad not in text, f"{name} still quotes stale figure {bad!r}"


def test_no_hardcoded_test_counts():
    for name, text in _md_texts().items():
        m = re.search(r"\b(\d+)\s+tests\b", text)
        assert m is None, (
            f"{name} hardcodes a test count ({m.group(0)!r}); counts drift — "
            "point at pytest instead"
        )
