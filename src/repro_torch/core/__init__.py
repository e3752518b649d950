"""Host planning and device sampling primitives of the port."""
