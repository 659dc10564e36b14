from .ops import (decode_attention, decode_attention_partial,  # noqa: F401
                  invocation_count, partial_invocation_count,
                  reset_invocation_count)
