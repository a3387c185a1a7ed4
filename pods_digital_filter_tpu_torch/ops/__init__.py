"""Numerical stages of the port.  Modules are imported where used; this
package ``__init__`` imports nothing, so loading one stage never loads the
others."""
