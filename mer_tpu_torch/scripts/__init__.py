"""Diagnostic entry points of the port."""
