"""Plain PyTorch references of the stencils, one module per kind.

Each module exposes ``make_step(config, precision, device)``, returning
``step(x) -> valid`` that advances a tensor one time step on its valid
region (every spatial extent shrinks by ``2r``), and ``CONTROL``, the
precision one step below the configuration's that the control runs in.
Nothing here imports the program: the tables are frozen copies of the
paper's stencils.
"""
