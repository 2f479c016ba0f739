"""Text front end of the port."""
