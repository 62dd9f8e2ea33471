"""Training stack of the port: optimizers and schedules (``optimizer``),
the train step and host loop (``train_loop``), checkpoint / restart in the
reference's on-disk format (``checkpoint``), straggler detection and mesh
planning (``fault_tolerance``), over trees of tensors (``tree``), on one
device or laid on a mesh of several (``distributed.sharding.place``)."""
