"""Operations and bytes counted from shapes, and the device's peaks."""
