"""Small shared helpers; `log` writes through `infolog`."""

from .infolog import ValueWindow, init as infolog_init, log  # noqa: F401
