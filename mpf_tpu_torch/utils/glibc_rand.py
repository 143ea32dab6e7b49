"""Pure-Python clone of glibc's ``rand()`` (TYPE_3 additive-feedback PRNG).

The reference's matrix generator relies on **unseeded glibc ``rand()``**
(`matrix_generator.cpp:63-66`), making the corpus deterministic run-to-run on
the same libc — SURVEY.md section 2 #9 calls this out as the reproducibility
mechanism.  To regenerate bit-identical corpora from Python (and to make
Python- and C++-generated corpora interchangeable, see
``native/matrix_generator.cpp``), this module reimplements glibc's default
generator exactly:

  * seeding: ``r[0] = seed``; ``r[i] = 16807 * r[i-1] mod 2^31-1`` for
    i in [1, 31) (computed with the Schrage trick like glibc does);
    ``r[i] = r[i-31]`` for i in [31, 34)
  * generation: ``r[i] = (r[i-3] + r[i-31]) mod 2^32``, output ``r[i] >> 1``

``tests/test_torch_utils.py`` checks it against the JAX package's copy.
"""

from __future__ import annotations

RAND_MAX = 2147483647


class GlibcRand:
    """glibc ``rand()``-compatible PRNG.  ``GlibcRand(1)`` matches an
    unseeded C program (glibc implicitly seeds with 1)."""

    __slots__ = ("_state", "_idx")

    def __init__(self, seed: int = 1):
        seed = seed & 0xFFFFFFFF
        if seed == 0:
            seed = 1
        state = [0] * 34
        state[0] = seed
        # glibc stores the seed in int32_t and runs the Schrage step in
        # SIGNED C arithmetic (truncated division), so seeds >= 2^31 enter
        # the recurrence as negative values; one `word += 2147483647` fix-up
        # brings the first iterate back into [0, 2^31) and all later
        # iterations take the non-negative path.
        word = seed if seed < 0x80000000 else seed - 0x100000000
        for i in range(1, 31):
            # word = (16807 * word) % 2147483647, Schrage-style without
            # overflow; hi/lo use C truncated division (round toward zero)
            q, rm = divmod(abs(word), 127773)
            hi = q if word >= 0 else -q
            lo = rm if word >= 0 else -rm
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            state[i] = word
        for i in range(31, 34):
            state[i] = state[i - 31]
        self._state = state
        self._idx = 34
        # glibc discards the first 310 outputs after seeding
        for _ in range(310):
            self._next_word()

    def _next_word(self) -> int:
        s = self._state
        word = (s[-3] + s[-31]) & 0xFFFFFFFF
        s.append(word)
        # keep the window bounded
        if len(s) > 1024:
            del s[:-34]
        return word

    def rand(self) -> int:
        """Next value in [0, RAND_MAX], bit-identical to glibc ``rand()``."""
        return self._next_word() >> 1

    def uniform(self) -> float:
        """``rand() / (RAND_MAX + 1.0)`` — the reference's sparsity draw
        (`matrix_generator.cpp:63`)."""
        return self.rand() / (RAND_MAX + 1.0)

    def ref_value(self) -> float:
        """``rand() % 100 / 10.0`` — the reference's matrix-entry distribution
        {0.0, 0.1, ..., 9.9} (`matrix_generator.cpp:66`)."""
        return (self.rand() % 100) / 10.0
