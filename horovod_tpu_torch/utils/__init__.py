"""Utilities of the port: leveled logging and the Chrome-trace timeline."""
