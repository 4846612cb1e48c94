"""Oracle for flash attention (full score matrix, exact softmax).

Shares the implementation with ``models.attention.naive_attention`` — that
function *is* the reference semantics the kernel must match.
"""

from __future__ import annotations

from ...models.attention import naive_attention as attention_ref

__all__ = ["attention_ref"]
