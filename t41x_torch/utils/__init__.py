"""Design-time helpers and conversion between t41x and the port."""
