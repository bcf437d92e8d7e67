"""PVN3D modules of the port (eval mode, channels-last at the interfaces)."""
