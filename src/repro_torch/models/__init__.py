"""The LM stack of the port: every family's prefill and decode, and the
dense family's loss."""
from .convert import params_from_reference
from .transformer import (DecodeCaches, ForwardOut, decode_step, forward,
                          forward_hidden, init_decode_state, init_model,
                          loss_fn)

__all__ = ["DecodeCaches", "ForwardOut", "decode_step", "forward",
           "forward_hidden", "init_decode_state", "init_model", "loss_fn",
           "params_from_reference"]
