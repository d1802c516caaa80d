"""Command line: flags, render-only mode and the entry point."""
