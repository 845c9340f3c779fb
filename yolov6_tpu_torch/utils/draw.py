"""Drawing of detections in numpy: the port's stand-in for ``cv2.rectangle``,
``cv2.getTextSize`` and ``cv2.putText`` as the JAX inferer calls them
(yolov6_tpu/core/inferer.py:204-230). The machine with the card has no cv2.

- ``rectangle`` fills the integer box when ``thickness < 0``; otherwise it
  draws the outline at ``cv2.rectangle(..., LINE_AA)``'s geometry (the same
  corners, the band of cv2's thick line around them with round outer joins)
  with anti-aliased edges of its own. Every pixel farther than 1 px from the
  band's edges equals cv2's. Both of the inferer's calls pass ``LINE_AA``,
  so that is the only line type.
- ``get_text_size`` equals ``cv2.getTextSize(text, FONT_HERSHEY_SIMPLEX,
  scale, thickness)[0]`` of OpenCV 5.0.0 for printable ASCII at the
  ``(lw / 3, max(lw - 1, 1))`` pairs that ``plot_box_and_label`` uses, lw 2
  to 20 (an image up to about 13,000 px in width plus height), and
  ``draw_text``'s ``(1, 2)``. That OpenCV measures text with a TrueType face
  in two weights (thickness 1 and below, 2 and above): a string is
  ``1 + sum`` of its characters' advances wide and ``round(27 * scale)``
  high. ``TEXT_ADVANCES`` holds the advances, measured from OpenCV 5.0.0's
  ``cv2.getTextSize(c, 0, lw / 3, max(lw - 1, 1))`` (each width less 1).
  Other pairs scale the nearest table of the same weight (an estimate).
  Characters outside printable ASCII count as ``'?'``.
- ``rectangle_line8`` is ``cv2.rectangle`` at its default ``LINE_8``, pixel
  for pixel (an outline of thickness 1, or cv2's thick polyline: bands of
  half-width ``(t + t % 2) // 2`` along the sides and a filled midpoint
  circle of radius ``(t + 1) // 2`` at each corner), as the JAX trainer's
  plots and ``vis_dataset`` call it.
- ``put_text`` writes the text in a 5x7 bitmap font of the port's own,
  inside the box that ``get_text_size`` gives; cv2's glyphs live inside its
  binary.
"""

from __future__ import annotations

import numpy as np

# lw -> the advances of chr(32)..chr(126), two hex digits each, at scale lw / 3
# and thickness max(lw - 1, 1)
TEXT_ADVANCES = {
    2: ("0404070d0b0e0d040b0b080b040904090b0b0b0b0b0b0b0b0b0b0405090a090a100c0c0c0d0b0b0d0d050c0b0a0f0d0d"
         "0c0d0c0b0b0d0c0f0c0c0b060906080e060a0b0a0b0a070b0b04040904110b0b0b0b0709070b0a0f0a0a090704070a"),
    3: ("07080c131216150612120c11070d070f1212121212121212121208080e100e1018141414141211141508131210171414"
         "13141312111413171313120a0e0a0d150b10111011100c1212070810071a121111110c0f0c12101710100f0b070b10"),
    4: ("090a101a191e1c09191911170a120a14191919191919191919190a0b13151316201b1a1a1b18171b1c0b1918161f1b1b"
         "191b1a19171b1a1f1919180e130e111c0e16171617161018180a0b150a221817171710141118161f1616140f090f15"),
    5: ("0c0d14211f26230b1f1f151d0d170d191f1f1f1f1f1f1f1f1f1f0d0e181b181b28212121221e1d22230e1f1f1c272221"
         "2021201f1d22202720201e1118111523121b1d1b1d1c141e1e0d0d1b0d2b1e1c1d1d141a151e1c271b1c1a130c131a"),
    6: ("0e101827252d2a0d252519230f1b0f1e2525252525252525252510101d201d2130282828282423282a112625212f2928"
         "262827252329272f262624151d151a2a1621232123211824240f10200f3424222323191f1924212f21211f170e1720"),
    7: ("11121d2e2c35310f2b2b1d29122012232b2b2b2b2b2b2b2b2b2b131322262227382f2e2e2f2a282f31142c2b27372f2f"
         "2c2f2d2b29302e372d2d2a1822181e311927292729271c2a2b121326123d2a2829291d241e2a27372627241b111b25"),
    8: ("13152134323d38123232222e14241528323232323232323232321516272b272c4036353536302e36381732312d3e3636"
         "333634322f37343f3333311c271c23381d2c2f2c2f2d20303115162b1545302e2f2f212922302c3f2c2d291f131f2a"),
    9: ("1618253b38443f14383826341729172d3838383838383838383818192c312c32483c3c3c3d36343d3f1a393732463d3c"
         "393c3b38353e3b473a3a371f2c1f273f213235323532243637171931174e36343535252e2636324731322e23162330"),
    10: ("181a29423e4c46163e3e2a3a192e1a323e3e3e3e3e3e3e3e3e3e1b1c3136313750434242443c3a44461d3f3e384e4443"
         "4043413e3b45414f40403d2331232b4724373b373b38293c3d1a1b361a573c393b3b29342b3c384f37383427182735"),
    11: ("1b1d2d4845544d1844442f401c321d37444444444444444444441d1e363b353d594a49494b42404b4d2045443e564b4a"
         "464a4845414c4857474743263626304e283d413d413d2d42431d1e3b1d60433f41412e392f423d573c3d392b1b2b3a"),
    12: ("1d20314f4b5b541b4b4b33461f371f3c4b4b4b4b4b4b4b4b4b4b20213a413a42615150505148465155234c4a435e5251"
         "4d514e4b47534e5e4d4d492a3b2a34552c43474347433148491f21411f6849454747323e3348435f42433e2f1d2f40"),
    13: ("2022355651635b1d5151374c213b22415151515151515151515123243f463f4869575656584e4c585c26525049665957"
         "535755514d59556654534f2e402e385c2f484d484d49354e4f22244622714f4b4d4d3643374e496747494333203345"),
    14: ("22253a5c586b621f57573b5224402546575757575757575757572627444c444e715e5d5d5f54515f632959574f6e5f5e"
         "595e5b5753605c6e5a5a553145313d63334e534e534e39545624274c257a555053533a493c544e6f4d4e483722374a"),
    15: ("25283e635e7269225e5e40582645274b5e5e5e5e5e5e5e5e5e5e282a4951495379656464665a57666a2c5f5d54766665"
         "6065625e5867627661605b354a35416a3753595359543d5a5c27295127835b5659593e4e405a547753544e3b243b50"),
    16: ("272a4269647a70246464445d29492a50646464646464646464642b2c4e574e59816c6a6a6d615d6d712f65635a7d6d6c"
         "666c69645e6e697e676762384f3846713a595f595f5a4160622a2c572a8b615c5f5f43534461597f585a533f273f55"),
    17: ("2a2d46706b8177266a6a48632c4e2d556a6a6a6a6a6a6a6a6a6a2e2f535c535e897371717467637478326c6960857473"
         "6d736f6a64756f866e6d683c543c4a783e5e655e655f4566682c2f5c2d9467626565475849675f875e5f584329435a"),
    18: ("2c304a7771897e2870704c692e522f5a70707070707070707070303258625864917978787a6d697a7f35726f658d7b79"
         "737976706a7c768e74746e3f593f4e7f42646b646b65496c6e2f32622f9d6d686b6b4b5d4d6d658f63655d472c4760"),
    19: ("2f324e7d7791852b7777516f3157325f7777777777777777777733355d675d6999807e7e81736f81863878766b958280"
         "79807c7770837c967b7a74435e435386456a716a716a4e727432356732a6736d71714f6351736a97696a624a2e4a65"),
    20: ("313552847d988c2d7d7d5575335c34647d7d7d7d7d7d7d7d7d7d3638626c616fa1878585887975888d3b7f7c719d8987"
         "8087837d768a839e81817a466346578e496f776f777052787b34376c34ae7973777753685679709f6e70684e314e6a"),
}
_ADV = {lw: np.frombuffer(bytes.fromhex(h), np.uint8).astype(np.int64)
        for lw, h in TEXT_ADVANCES.items()}

# the 5x7 font: chr(32)..chr(126), five columns each, bit 0 the top row
_FONT = bytes.fromhex(
    "000000000000005f00000007000700147f147f14242a7f2a12231308646236495522500005030000001c224100"
    "0041221c00082a1c2a0808083e080800503000000808080808006060000020100804023e5149453e00427f4000"
    "42615149462141454b311814127f1027454545393c4a49493001710905033649494936064949291e0036360000"
    "0056360000000814224114141414144122140800020151090632497941317e1111117e7f494949363e41414122"
    "7f4141221c7f494949417f090901013e414151327f0808087f00417f41002040413f017f081422417f40404040"
    "7f0204027f7f0408107f3e4141413e7f090909063e4151215e7f09192946464949493101017f01013f4040403f"
    "1f2040201f7f2018207f63140814630304780403615149454300007f4141020408102041417f00000402010204"
    "4040404040000102040020545454787f484444383844444420384444487f3854545418087e090102081454543c"
    "7f0804047800447d40002040443d00007f10284400417f40007c041804787c0804047838444444387c14141408"
    "081414187c7c080404084854545420043f4440203c4040207c1c2040201c3c4030403c44281028440c5050503c"
    "4464544c44000836410000007f000000413608000201020402"
)
_GLYPHS = np.unpackbits(np.frombuffer(_FONT, np.uint8).reshape(95, 5, 1), axis=2,
                        bitorder="little")[:, :, :7].transpose(0, 2, 1).astype(bool)  # [95, 7, 5]


def _codes(text: str) -> np.ndarray:
    """Indices into the tables: printable ASCII, every other byte as ``'?'``."""
    b = np.frombuffer(str(text).encode("utf-8"), np.uint8).astype(np.int64)
    return np.where((b >= 32) & (b < 127), b, ord("?")) - 32


def _advances(font_scale: float, thickness: int) -> np.ndarray:
    lw = int(round(font_scale * 3))
    if lw in _ADV and abs(lw / 3 - font_scale) < 1e-9 and (lw >= 3) == (thickness >= 2):
        return _ADV[lw]
    # not measured: the nearest table of the weight, scaled
    tables = [k for k in _ADV if (k >= 3) == (thickness >= 2)]
    lw = min(tables, key=lambda k: abs(k / 3 - font_scale))
    return np.rint(_ADV[lw] * (font_scale / (lw / 3))).astype(np.int64)


def get_text_size(text: str, font_scale: float, thickness: int):
    """``(w, h)``, as ``cv2.getTextSize(text, 0, font_scale, thickness)[0]``
    (module doc)."""
    codes = _codes(text)
    if not len(codes):
        return 0, 0
    w = 1 + int(_advances(font_scale, thickness)[codes].sum())
    return w, int(np.floor(27 * font_scale + 0.5))


def rectangle(img: np.ndarray, p1, p2, color, thickness: int) -> None:
    """Draw on ``img`` (HxWx3 uint8, in place) the box with corners ``p1`` and
    ``p2``: filled (the integer box, both corners included) when
    ``thickness < 0``, else its anti-aliased outline (module doc)."""
    x1, x2 = sorted((int(p1[0]), int(p2[0])))
    y1, y2 = sorted((int(p1[1]), int(p2[1])))
    H, W = img.shape[:2]
    if thickness < 0:
        img[max(y1, 0):max(y2 + 1, 0), max(x1, 0):max(x2 + 1, 0)] = color
        return
    # cv2's ThickLine: each side a band of half-width (t + t % 2) / 2, each
    # corner a disc of radius t / 2; pixels up to 1 px beyond take a share
    # of the colour
    hw = (thickness + (thickness & 1)) / 2
    r = int(hw) + 1
    rows = [(y1 - r, y2 + r)] if y2 - y1 <= 2 * r + 1 else [(y1 - r, y1 + r), (y2 - r, y2 + r)]
    cols = [(x1 - r, x2 + r)] if x2 - x1 <= 2 * r + 1 else [(x1 - r, x1 + r), (x2 - r, x2 + r)]
    regions = [(ya, yb, x1 - r, x2 + r) for ya, yb in rows]
    if len(rows) == 2:  # the sides between the top and bottom bands
        regions += [(y1 + r + 1, y2 - r - 1, xa, xb) for xa, xb in cols]
    for ya, yb, xa, xb in regions:
        ya, yb, xa, xb = max(ya, 0), min(yb, H - 1), max(xa, 0), min(xb, W - 1)
        if ya > yb or xa > xb:
            continue
        y = np.arange(ya, yb + 1, dtype=np.float32)[:, None]
        x = np.arange(xa, xb + 1, dtype=np.float32)[None, :]
        dx = np.maximum(np.maximum(x1 - x, x - x2), 0)
        dy = np.maximum(np.maximum(y1 - y, y - y2), 0)
        outside = np.sqrt(dx * dx + dy * dy)
        inside = np.minimum(np.minimum(x - x1, x2 - x), np.minimum(y - y1, y2 - y))
        d = np.where((dx > 0) | (dy > 0), outside, inside)  # to the box's edge
        reach = np.where((dx > 0) & (dy > 0), thickness / 2, hw)
        alpha = np.clip(reach + 1 - d, 0, 1)[..., None]
        region = img[ya:yb + 1, xa:xb + 1].astype(np.float32)
        img[ya:yb + 1, xa:xb + 1] = np.rint(
            region + (np.asarray(color, np.float32) - region) * alpha).astype(np.uint8)


def _circle_offsets(r: int):
    """The pixels of cv2's filled ``Circle`` of radius ``r`` (its midpoint
    walk), as ``(dy, dx)`` offsets."""
    pts = set()
    err, dx, dy, plus, minus = 0, r, 0, 1, (r << 1) - 1
    while dx >= dy:
        for y, half in ((-dy, dx), (dy, dx), (-dx, dy), (dx, dy)):
            pts.update((y, x) for x in range(-half, half + 1))
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return sorted(pts)


def rectangle_line8(img: np.ndarray, p1, p2, color, thickness: int = 1) -> None:
    """``cv2.rectangle(img, p1, p2, color, thickness)`` at ``LINE_8`` (module
    doc), in place; pixels outside ``img`` are dropped."""
    x1, x2 = sorted((int(p1[0]), int(p2[0])))
    y1, y2 = sorted((int(p1[1]), int(p2[1])))
    H, W = img.shape[:2]

    def fill(ya, yb, xa, xb):
        ya, yb, xa, xb = max(ya, 0), min(yb, H - 1), max(xa, 0), min(xb, W - 1)
        if ya <= yb and xa <= xb:
            img[ya:yb + 1, xa:xb + 1] = color

    h = 0 if thickness <= 1 else (thickness + (thickness & 1)) // 2
    fill(y1 - h, y1 + h, x1, x2)
    fill(y2 - h, y2 + h, x1, x2)
    fill(y1, y2, x1 - h, x1 + h)
    fill(y1, y2, x2 - h, x2 + h)
    if thickness > 1:
        for dy, dx in _circle_offsets((thickness + 1) // 2):
            for cy, cx in ((y1, x1), (y1, x2), (y2, x1), (y2, x2)):
                if 0 <= cy + dy < H and 0 <= cx + dx < W:
                    img[cy + dy, cx + dx] = color


def put_text(img: np.ndarray, text: str, org, font_scale: float, color, thickness: int) -> None:
    """Write ``text`` on ``img`` in place with its baseline's left end at
    ``org``, in the port's 5x7 font: rows of ``h // 9`` px (``h`` the text's
    height), each character centred in its advance from ``get_text_size``'s
    table and at most 1 px narrower, so that the text stays inside that
    box."""
    codes = _codes(text)
    if not len(codes):
        return
    adv = _advances(font_scale, thickness)
    u = max(get_text_size(text, font_scale, thickness)[1] // 9, 1)
    H, W = img.shape[:2]
    x, base = int(org[0]), int(org[1])
    for c in codes:
        gw = max(min(5 * u, int(adv[c]) - 1), 1)
        glyph = np.repeat(_GLYPHS[c], u, 0)[:, np.arange(gw) * 5 // gw]  # [7u, gw]
        gx = x + (int(adv[c]) - gw) // 2
        gy = base - 7 * u
        ya, xa = max(gy, 0), max(gx, 0)
        yb, xb = min(gy + 7 * u, H), min(gx + gw, W)
        if ya < yb and xa < xb:
            img[ya:yb, xa:xb][glyph[ya - gy:yb - gy, xa - gx:xb - gx]] = color
        x += int(adv[c])


def draw_text(img, text, pos=(0, 0), font_scale=1, font_thickness=2, text_color=(0, 255, 0),
              text_color_bg=(0, 0, 0)):
    """The JAX inferer's ``draw_text`` (yolov6_tpu/core/inferer.py:204-217)
    over this module's text size, box and font."""
    offset = (5, 5)
    x, y = pos
    text_size = get_text_size(text, font_scale, font_thickness)
    text_w, text_h = text_size
    rec_start = tuple(x - y for x, y in zip(pos, offset))
    rec_end = tuple(x + y for x, y in zip((x + text_w, y + text_h), offset))
    rectangle(img, rec_start, rec_end, text_color_bg, -1)
    put_text(img, text, (x, int(y + text_h + font_scale - 1)), font_scale, text_color,
             font_thickness)
    return text_size


def plot_box_and_label(image, lw, box, label="", color=(128, 128, 128),
                       txt_color=(255, 255, 255)):
    """The JAX inferer's ``plot_box_and_label`` (yolov6_tpu/core/inferer.py:
    219-230) over this module's rectangle, text size and font."""
    p1, p2 = (int(box[0]), int(box[1])), (int(box[2]), int(box[3]))
    rectangle(image, p1, p2, color, thickness=lw)
    if label:
        tf = max(lw - 1, 1)
        w, h = get_text_size(label, font_scale=lw / 3, thickness=tf)
        outside = p1[1] - h - 3 >= 0
        p2 = p1[0] + w, p1[1] - h - 3 if outside else p1[1] + h + 3
        rectangle(image, p1, p2, color, -1)
        put_text(image, label, (p1[0], p1[1] - 2 if outside else p1[1] + h + 2),
                 lw / 3, txt_color, thickness=tf)
