"""Color conversions (reference src/utils/colors.cpp:24-36)."""


def rgb_to_xyz(r: float, g: float, b: float) -> tuple[float, float, float]:
    """Convert sRGB255 coordinates to XYZ1 under D65 illuminant.

    Matches the reference's RGBToXYZ: inverse sRGB companding with the
    12.92-linear segment below 0.040449936, then the inverse of the standard
    XYZ->lRGB matrix.
    """
    def lin(c255: float) -> float:
        c1 = c255 / 255.0
        if c1 <= 0.040449936:
            return c1 / 12.92
        return ((c1 + 0.055) / 1.055) ** 2.4

    lr, lg, lb = lin(r), lin(g), lin(b)
    x = 0.4123955889674142 * lr + 0.3575834307637148 * lg + 0.18049264738170154 * lb
    y = 0.21258623078559552 * lr + 0.715170303703411 * lg + 0.0722004986433362 * lb
    z = 0.019297215491746938 * lr + 0.11918386458084851 * lg + 0.9504971251315798 * lb
    return x, y, z
