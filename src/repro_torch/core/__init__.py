"""The executable VLA control step of the port."""
