"""Seeded synthetic email-header data for benchmarks and the chip check.

``email_corpus`` gives padded header blocks: random lower-case filler
(spaces included, random length), then
``\\r\\nfrom:<name>@<domain>\\r\\n``; every seventh block is cut in half
so a batch mixes matching and failing strings.  ``email_lines`` gives
newline-free header lines for line-oriented corpus files.
"""

from __future__ import annotations

import numpy as np

DOMAINS = (b"gmail.com", b"x.yz", b"sub.domain-x.org")


def email_corpus(n: int, max_len: int, seed: int = 0):
    """(chars uint8 [n, max_len], lengths int32 [n]): ``n`` header blocks,
    each at most ``max_len`` bytes."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    alpha_sp = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", np.uint8)
    chars = np.zeros((n, max_len), np.uint8)
    lengths = np.zeros((n,), np.int32)
    for i in range(n):
        name = rng.choice(alpha, size=8).tobytes()
        tail = b"\r\nfrom:" + name + b"@" + DOMAINS[i % 3] + b"\r\n"
        filler_len = int(rng.integers(0, max(1, max_len - len(tail) + 1)))
        s = rng.choice(alpha_sp, size=filler_len).tobytes() + tail
        if i % 7 == 3:
            s = s[: len(s) // 2]
        s = s[:max_len]
        chars[i, : len(s)] = np.frombuffer(s, np.uint8)
        lengths[i] = len(s)
    return chars, lengths


def email_lines(n: int, seed: int = 0):
    """``n`` newline-free header lines (each ends in ``\\r``, so a scan
    that restores the ``\\n`` terminator sees ``...\\r\\n``): plain and
    display-name `from:` headers, which match the `from:` model, and
    cut-off headers and other text, which do not."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    alpha_sp = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", np.uint8)
    lines = []
    for i in range(n):
        name = rng.choice(alpha, size=int(rng.integers(3, 12))).tobytes()
        addr = name + b"@" + DOMAINS[i % 3]
        kind = i % 4
        if kind == 0:
            s = b"from:" + addr + b"\r"
        elif kind == 1:
            s = b"from:" + name.title() + b" X <" + addr + b">\r"
        elif kind == 2:
            s = b"from:" + addr[: len(addr) // 2] + b"\r"
        else:
            s = rng.choice(alpha_sp, size=int(rng.integers(1, 200))).tobytes()
        lines.append(s)
    return lines
