"""float32 arithmetic in the reference's evaluation order.

The encoder's RD decisions are argmins over float32 costs built from
fractional bit estimates; two evaluation orders of one formula can round
one ulp apart and flip a near tie.  The JAX reference compiles those
formulas with XLA on the CPU, which

* contracts `c + a * b` into one fused multiply-add (a single rounding),
* reduces a row in consecutive 32-element chunks, each summed left to
  right, then sums the chunk partials left to right; a row of at most 32
  is summed left to right, or, where XLA vectorizes the loop, in a
  halving tree (x[:n/2] + x[n/2:], repeated),
* evaluates a cumulative sum in 16-element chunks (a left-to-right prefix
  inside each chunk, then the prefix of the chunk totals added on),
* sums a whole 2-D grid by first reducing each dimension longer than 32
  in windows of 32 (zero padding split evenly around the grid), each
  window element by element in row-major order, then summing what is
  left: row by row, then over the rows in a halving tree where there
  are 2, 4 or 8 rows of at most 8, else element by element,
* divides by a constant as a multiply by its float32 reciprocal,
* evaluates `2.0 ** y` as the correctly rounded power of two.

The helpers here reproduce those orders with plain tensor ops, so the
port's costs are bit-identical on every device.  The fused multiply-add
is evaluated in float64 (the product of two float32 values is exact
there) and rounded once to float32.
"""
from __future__ import annotations

import torch


def fma(a, b, c) -> torch.Tensor:
    """round_f32(a * b + c) with one rounding (tensors or Python floats;
    at least one argument must be a tensor)."""

    def d(x):
        if isinstance(x, torch.Tensor):
            return x.to(torch.float64)
        # the float32 value as a Python float: an operand of the kernel,
        # not a tensor to upload
        return float(torch.tensor(x, dtype=torch.float32))
    return (d(a) * d(b) + d(c)).to(torch.float32)


def row_sum(x: torch.Tensor, tree: bool = False) -> torch.Tensor:
    """float32 sum over the last axis in XLA-CPU order (`tree`: a row of
    at most 32 that XLA sums in a halving tree)."""
    n = x.shape[-1]
    if n <= 32 and tree:
        while x.shape[-1] > 1:
            h = x.shape[-1] // 2
            x = x[..., :h] + x[..., h:]
        return x[..., 0]
    if n <= 32:
        return _seq(x.unbind(-1))
    assert n % 32 == 0, n
    chunks = x.reshape(*x.shape[:-1], n // 32, 32)
    part = _seq(chunks.unbind(-1))                   # [..., n/32]
    return _seq(part.unbind(-1))


def _seq(cols) -> torch.Tensor:
    acc = cols[0]
    for c in cols[1:]:
        acc = acc + c
    return acc


def grid_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 sum of a 2-D grid [r, c] in XLA-CPU's order (jnp.sum of
    the whole grid; the order was read off XLA's optimised program and
    checked against it for every multiple-of-4 shape up to 68 x 120)."""
    r, c = x.shape
    if r > 32 or c > 32:
        def window(n):            # (window, padding before, after)
            if n <= 32:
                return n, 0, 0
            pad = -n % 32
            return 32, pad // 2, pad - pad // 2
        (wr, lr, hr), (wc, lc, hc) = window(r), window(c)
        xp = torch.nn.functional.pad(x, (lc, hc, lr, hr))
        nr, nc = xp.shape[0] // wr, xp.shape[1] // wc
        win = xp.reshape(nr, wr, nc, wc).permute(0, 2, 1, 3) \
            .reshape(nr, nc, wr * wc)
        x = _seq(win.unbind(-1))
        r, c = nr, nc
    if r in (2, 4, 8) and c <= 8:
        x = _seq(x.unbind(-1))
        while x.shape[0] > 1:
            x = x[:x.shape[0] // 2] + x[x.shape[0] // 2:]
        return x[0]
    return _seq(x.reshape(-1).unbind(0))


def cumsum0(x: torch.Tensor) -> torch.Tensor:
    """float32 inclusive cumulative sum over axis 0 in XLA-CPU order."""
    n = x.shape[0]
    if n <= 16:
        out, acc = [], None
        for i in range(n):
            acc = x[i] if acc is None else acc + x[i]
            out.append(acc)
        return torch.stack(out)
    m = -(-n // 16) * 16
    if m > n:
        x = torch.cat([x, x.new_zeros((m - n,) + x.shape[1:])])
    ch = x.reshape(m // 16, 16, *x.shape[1:])
    pre = torch.stack([cumsum0(c) for c in ch])      # [nc, 16, ...]
    tot = cumsum0(pre[:, -1])
    carry = torch.cat([torch.zeros_like(tot[:1]), tot[:-1]])
    return (pre + carry[:, None]).reshape(m, *x.shape[1:])[:n]


def exp2(y: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 2**y of a float32 tensor."""
    return torch.exp2(y.to(torch.float64)).to(torch.float32)
