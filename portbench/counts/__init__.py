"""Operations and bytes a call needs, from a configuration and its shapes."""
