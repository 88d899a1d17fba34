"""Model configurations (frozen dataclasses), as in the reference."""
