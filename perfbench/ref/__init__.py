"""The benchmark's plain reference: frozen numpy copies of the port's
oracles and table builders (``config``, ``tables``, ``float_ref``,
``int_ref``) and their vectorised plain-torch form (``torch_ref``), which
judges the timed path at the timed sizes on the card.  Nothing here imports
the program or JAX."""
