"""`python -m hast_jax` == `python -m hast_jax.cli`."""

from hast_jax.cli import main

if __name__ == "__main__":
    main()
