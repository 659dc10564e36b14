from .ops import (backward_invocation_count, flash_attention,  # noqa: F401
                  invocation_count, reset_invocation_count)
