"""Three-valued (Kleene) logic over paired bit-vectors (port of
``bitmagic_tpu/algo/kleene.py``).

Equivalent of `src/bm3vl.h`: a 3VL variable is a (value, known) pair of
bit-vectors with the invariant value ⊆ known; true = known∧value,
false = known∧¬value, unknown = ¬known.  Values use the reference encoding:
+1 true, -1 false, 0 unknown.  Every pair op is BitVector set algebra, so
its dense rows go through K1.
"""

from __future__ import annotations

from ..core.bitvector import BitVector


def init_kleene(value: BitVector, known: BitVector):
    """Enforce the invariant value &= known (reference init_kleene,
    src/bm3vl.h:54)."""
    value.bit_and(known)
    return value, known


def get_value_kleene(value: BitVector, known: BitVector, i: int) -> int:
    """-1 / 0 / +1 at position i (reference get_value_kleene,
    src/bm3vl.h:69)."""
    if not known.test(i):
        return 0
    return 1 if value.test(i) else -1


def set_value_kleene(value: BitVector, known: BitVector, i: int, v: int):
    """Set position i to -1/0/+1 (reference set_value_kleene,
    src/bm3vl.h:96)."""
    if v == 0:
        known.set(i, False)
        value.set(i, False)
    else:
        known.set(i, True)
        value.set(i, v > 0)


def invert_kleene(value: BitVector, known: BitVector):
    """Kleene NOT: true<->false, unknown stays unknown (reference
    invert_kleene, src/bm3vl.h:135)."""
    value.bit_xor(known)
    return value


def and_kleene(v1, k1, v2, k2):
    """Kleene AND -> new (value, known) pair (reference and_kleene 3-op,
    src/bm3vl.h:195): false dominates, unknown absorbs true."""
    value = v1 & v2
    # known when either side is known-false, or both sides are known
    known = (k1 & k2) | (k1 - v1) | (k2 - v2)
    return value, known


def or_kleene(v1, k1, v2, k2):
    """Kleene OR (reference or_kleene 3-op, src/bm3vl.h:151): true
    dominates, unknown absorbs false."""
    value = v1 | v2
    known = value | (k1 & k2)
    return value, known


def and_kleene_inplace(v1, k1, v2, k2):
    """2-operand form: (v1,k1) &= (v2,k2) (reference src/bm3vl.h:245)."""
    value, known = and_kleene(v1, k1, v2, k2)
    v1.swap(value)
    k1.swap(known)
    return v1, k1


def or_kleene_inplace(v1, k1, v2, k2):
    value, known = or_kleene(v1, k1, v2, k2)
    v1.swap(value)
    k1.swap(known)
    return v1, k1


def and_values_kleene(a: int, b: int) -> int:
    """Kleene AND on scalar values -1/0/1 = false/unknown/true (reference
    and_values_kleene, src/bm3vl.h:271)."""
    return min(int(a), int(b))


def or_values_kleene(a: int, b: int) -> int:
    """Kleene OR on scalar values (reference or_values_kleene,
    src/bm3vl.h:311)."""
    return max(int(a), int(b))
