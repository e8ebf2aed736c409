"""Prime/factor arithmetic for the planner.

Re-implementation of FFTW's kernel prime helpers
(reference ``fftw/fftw_api.c:15750-15915``: ``fftw_is_prime``,
``fftw_power_mod``, ``fftw_find_generator``, ``fftw_factors_into_small_primes``,
``fftw_choose_radix``).  Pure host-side Python — runs at plan time only.
"""
from __future__ import annotations

from functools import lru_cache
from typing import List


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    if n < 4:
        return True
    if n % 2 == 0:
        return False
    d = 3
    while d * d <= n:
        if n % d == 0:
            return False
        d += 2
    return True


def factorize(n: int) -> List[int]:
    """Prime factorization, ascending."""
    out: List[int] = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1 if d == 2 else 2
    if n > 1:
        out.append(n)
    return out


def largest_prime_factor(n: int) -> int:
    f = factorize(n)
    return f[-1] if f else 1


def is_smooth(n: int, bound: int) -> bool:
    """True iff all prime factors of n are <= bound."""
    return largest_prime_factor(n) <= bound


def power_mod(base: int, exp: int, p: int) -> int:
    return pow(base, exp, p)


@lru_cache(maxsize=None)
def find_generator(p: int) -> int:
    """Smallest primitive root modulo prime p (fftw_find_generator analog)."""
    if p == 2:
        return 1
    phi = p - 1
    pf = sorted(set(factorize(phi)))
    for g in range(2, p):
        if all(pow(g, phi // f, p) != 1 for f in pf):
            return g
    raise ValueError(f"no generator for {p} (not prime?)")


def divisors(n: int) -> List[int]:
    """All divisors of n, ascending."""
    small, large = [], []
    d = 1
    while d * d <= n:
        if n % d == 0:
            small.append(d)
            if d != n // d:
                large.append(n // d)
        d += 1
    return small + large[::-1]


@lru_cache(maxsize=None)
def next_fast_size(n: int, smooth: int = 5) -> int:
    """Smallest `smooth`-smooth integer >= n (Bluestein padded-size chooser,
    analog of choose_transform_size, fftw/fftw_api.c:1738-1743)."""
    m = n
    while not is_smooth(m, smooth):
        m += 1
    return m


def next_pow2(n: int) -> int:
    m = 1
    while m < n:
        m *= 2
    return m
