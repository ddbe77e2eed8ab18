"""Serving substrate of the port: partial STKDE answers so far (the
language-model ``ServingEngine`` of the reference arrives with the LM
stack)."""
from .engine import PartialGridAnswer, stkde_partial_answer

__all__ = ["PartialGridAnswer", "stkde_partial_answer"]
