"""Data of the port's figures, written by ``python
tests/test_torch_viz.py --write-tables`` (matplotlib 3.10.8, OpenCV
5.0.0) and held against them by ``tests/test_torch_viz.py``:

- ``LUTS``: matplotlib's colormaps as ``Colormap(x, bytes=True)``
  reads them, ``(N + 3, 4)`` uint8 (N colours, then under, over and
  bad), zlib and base64;
- ``JET_BGR``: OpenCV's ``COLORMAP_JET`` (``applyColorMap`` of 0..255),
  (256, 3) uint8 BGR;
- ``CYCLE``: matplotlib's default colour cycle (C0-C9);
- ``GLYPHS``: DejaVu Sans at 40 pixels per em, drawn by FreeType
  as matplotlib's Agg backend draws it: one atlas of coverage (0-255),
  ``GLYPH_ROWS`` rows, the baseline at row ``GLYPH_BASELINE``, and per
  character its first column, cell width and advance in pixels.
"""

GLYPH_PX = 40
GLYPH_ROWS = 52
GLYPH_BASELINE = 40
GLYPH_COLUMNS = 2364
GLYPH_CELLS = {
    ' ': (0, 13, 12.7148),
    '!': (13, 17, 16.0352),
    '"': (30, 19, 18.3984),
    '#': (49, 34, 33.5156),
    '$': (83, 26, 25.4492),
    '%': (109, 39, 38.0078),
    '&': (148, 32, 31.1914),
    "'": (180, 11, 10.9961),
    '(': (191, 16, 15.6055),
    ')': (207, 16, 15.6055),
    '*': (223, 20, 20.0),
    '+': (243, 34, 33.5156),
    ',': (277, 13, 12.7148),
    '-': (290, 15, 14.4336),
    '.': (305, 13, 12.7148),
    '/': (318, 15, 13.4766),
    '0': (333, 26, 25.4492),
    '1': (359, 26, 25.4492),
    '2': (385, 26, 25.4492),
    '3': (411, 26, 25.4492),
    '4': (437, 26, 25.4492),
    '5': (463, 26, 25.4492),
    '6': (489, 26, 25.4492),
    '7': (515, 26, 25.4492),
    '8': (541, 26, 25.4492),
    '9': (567, 26, 25.4492),
    ':': (593, 14, 13.4766),
    ';': (607, 14, 13.4766),
    '<': (621, 34, 33.5156),
    '=': (655, 34, 33.5156),
    '>': (689, 34, 33.5156),
    '?': (723, 22, 21.2305),
    '@': (745, 40, 40.0),
    'A': (785, 28, 27.3633),
    'B': (813, 28, 27.4414),
    'C': (841, 28, 27.9297),
    'D': (869, 31, 30.8008),
    'E': (900, 26, 25.2734),
    'F': (926, 24, 23.0078),
    'G': (950, 31, 30.9961),
    'H': (981, 31, 30.0781),
    'I': (1012, 12, 11.7969),
    'J': (1024, 12, 11.7969),
    'K': (1036, 28, 26.2305),
    'L': (1064, 23, 22.2852),
    'M': (1087, 35, 34.5117),
    'N': (1122, 30, 29.9219),
    'O': (1152, 32, 31.4844),
    'P': (1184, 25, 24.1211),
    'Q': (1209, 32, 31.4844),
    'R': (1241, 28, 27.793),
    'S': (1269, 26, 25.3906),
    'T': (1295, 26, 24.4336),
    'U': (1321, 30, 29.2773),
    'V': (1351, 28, 27.3633),
    'W': (1379, 40, 39.5508),
    'X': (1419, 28, 27.4023),
    'Y': (1447, 26, 24.4336),
    'Z': (1473, 28, 27.4023),
    '[': (1501, 16, 15.6055),
    '\\': (1517, 15, 13.4766),
    ']': (1532, 16, 15.6055),
    '^': (1548, 34, 33.5156),
    '_': (1582, 22, 20.0),
    '`': (1604, 20, 20.0),
    'a': (1624, 25, 24.5117),
    'b': (1649, 26, 25.3906),
    'c': (1675, 22, 21.9922),
    'd': (1697, 26, 25.3906),
    'e': (1723, 25, 24.6094),
    'f': (1748, 16, 14.082),
    'g': (1764, 26, 25.3906),
    'h': (1790, 26, 25.3516),
    'i': (1816, 12, 11.1133),
    'j': (1828, 12, 11.1133),
    'k': (1840, 24, 23.1641),
    'l': (1864, 12, 11.1133),
    'm': (1876, 39, 38.9648),
    'n': (1915, 26, 25.3516),
    'o': (1941, 25, 24.4727),
    'p': (1966, 26, 25.3906),
    'q': (1992, 26, 25.3906),
    'r': (2018, 17, 16.4453),
    's': (2035, 21, 20.8398),
    't': (2056, 16, 15.6836),
    'u': (2072, 26, 25.3516),
    'v': (2098, 24, 23.6719),
    'w': (2122, 33, 32.7148),
    'x': (2155, 24, 23.6719),
    'y': (2179, 24, 23.6719),
    'z': (2203, 21, 20.9961),
    '{': (2224, 26, 25.4492),
    '|': (2250, 14, 13.4766),
    '}': (2264, 26, 25.4492),
    '~': (2290, 34, 33.5156),
    '—': (2324, 40, 40.0),
}
GLYPH_ATLAS = (
    "eNrtnQd4FMXbwDfl0gMJNYSOtNCrIAEJICI2iqKACNhQUUCagFLFBoiKioqAVEWqICAI/CEg"
    "HUGk9xYSAoSWkHLJ5eabd+vM7OzdXnLhC7rv8yiX25sts1N+87YRBEssscQSSyyxxBJLLLHE"
    "EkssscQSSyyxxBJLLLHEEkssscQSSyyxxBJLLLHEEkssscQSSyyxxBJLLLHEEkssscQSSyyx"
    "xBJLLLHEEkssscQSSyyxxBJLLClQ6eRAaLxVDZZY4i3pi+ZalWCJJZZY8q+WVxByPmFVgyWW"
    "FCA7RU0+ejft8KelqC+XIDREX7zYu5uu2O8cm/2kn7sLRV5DqIX08T2ENuiOV0Ko0r177Kh3"
    "4s9nXT3wVTPTJeoOW3Lydvb1I3N6BVLfV+w6ftGeS2mO9MStn7Xw0t01n7rrek7W1b2z+1Ux"
    "VyDg+TmHU3LuJmyYUJ05EtRn0enbmee2DC1X2FpelaHLTt3Kufn31w3v+aUDWn+45dj17JST"
    "v71b8Bf3azpi7T+JWWmX9s9+7YH7eqwo/cYvR247MhO3TWnjm8eCcZ4VDH9l3uFr9vSk7d/1"
    "KvFvHYHHI0ku8A9Xkg/nf3QchdCtqmZnBYTi8n6lCwjFm/iZzxMLT9xxGj65+5uJw0f6cv4w"
    "KkH93pJ7IBH9lh5KySQVnhco9SdypCbEf97iHt4RdCW6d0FLmcttsesRGiR+OIrQE6bY6dE7"
    "Ume91Zb4sj1Ch/z1pdOUnp3Qz1/f58n2+w1Cy+SPIYkIdbnX7BSIb7W70mkHZSr3/Ss5JgfG"
    "PDXku00Xc3Vdr+qHF5Aq197gDW2iHHiQd+lGOczYN5cqxI4djXcSx5Qv45FOtBI9ktUvnUtL"
    "k+fqkaAcyB7jX5g61ZPbtQf5uWhez7Icijc0mGwQyry694enbWyhoCHXiFrc28uHKee4e+Wf"
    "VZ92LW54WkXiDI6QPcr22nny0J99/ckTXtDNOWozYQ6rf7LFyhyG8440OqV2g0foL4eLX46n"
    "fjKOvRny7/Jzc7TnONPbh1s36Ul7vu3ErKOogqdf5FdqxpX9M3sEMYj7QZpWMHdzj0CD96DV"
    "+njEGqbUKhmEP8zWVU053Nev2sRy7xBfL4VmQLbKg/iLivjf6FsI3aaWIQF/407XASMy9NpX"
    "6LMHn8TfdeR2Xq0DU+yEC7xvlp185uFvbzcy31u+xGN4SOFhp7A/XFOjxU73vcTJI60xO0my"
    "yO+e3ZIH7OSPh5964toPjwZFzLBT/SyUPTiy2PAclFlbo4pTyBmrKzyEM5MYsFMtB8qtofzx"
    "BkJnbfeYnR7H+KCMhvOJ204ox2WaON2kRshyf6MpNfdljpbjEPKEnd7KRqbYKVst8Rn1fVI1"
    "7Vyfkgc2BRSeTkVX275w/S9CO3+++WKaI+1y/PRnjNiqpFhVX7uGnIRn6OMtLzM/2FGHW86x"
    "obNvvtmp8Tn24LGOXmWnymeg1b0huGcnRHP9MQ473SluzE690+jn2FTSsG4SugouCm4sYVjw"
    "JrkqEYofYKqub37YqbgdobRQtmpG48OfSZPqSuLrq3DCp4hbcSJ0Tvz0Ij7wB3mGT5UWWC0d"
    "V2BF6uxf4WMzBE/YaTJCe8yy0wzx65Q6pjudz094nVJ42GkhstjJQxS5z+4/PAWZYyd57VfI"
    "2Kk57l3iErEHXmJzG+ZCH/qbXbJx7l2EtqtfjkHoR13Z+qCgWdu2SFjTL1LdsdNyhJZqJHYF"
    "IXWYLLE9lmSn2O0Fo52foRkKYbSyT6oVXK7Pafzp71Bz7LRj1IOlA8o8I46D88jHvDn/pXrF"
    "/Is2GXER9D4ddVeeiDxhp6HwzW8vVAkNq/HqRqcLdlK0eEI/+Gt7t7K28AcnZeCPZ9XlO6y1"
    "0epHiwdVGwateGHhYqf979QKDW+5CO5xuk5VtyCdeNSshU25Z5HY/UagGwXRKGoqt8NbWj+o"
    "YXRAyfq9foUKizeCowNN88lOPeH0aNv7LSuF+5d4cOAfDqLneoWdaiUCRfcQzLDT9+R3DyEO"
    "O6Ephuw0Dg6nzupYKah43UF74I9zFY3r5mNXBc+UNy44h9DY/SW23h7VwgIqdPgyIb/sBE4H"
    "6CWWJoA8a+EBKRN3Y42UY8QTfqH9ritSx7+V+OPr2pFWeAw8HiwtevCRzeRg2haIK8wMO6lj"
    "Qyxum2X0b3A8h52+lM+SXMN0r7P9gdDgwsJOD0DtPBHhk4+bsdipcMsrMBv1qBDEtA2yh/oW"
    "bTod/+pSYWSnkcokOxOhycyx8sPWnMEzSXbCvkXvNFcmoCa4N4oKisDrCCkK4coZ6IYeaX7R"
    "Bpgyi12zU0P8V2PtIOayy4oWZDpyzohQ2ClihhN9UxBV5pOE0FvSx5p4BstsI36M3EMNtjOO"
    "//b5m+0rzdezU+6CBsrnEVD7jyh/VfxfV1UJFQompPOsaaxRDrJf0rOTwX22xiPKNfXitdbx"
    "f3UUn+Ax+XPIDfzH5/IQVAe/NDRCPlIdbCWyk1r0Cfy5UyFipxOdCFjMoQ1klVfo5pmlPH+t"
    "IwiBUuN5g9nSJ6zOgLNQuB09C6LtWlOM/MhOsJNYzqdIhSav/3gTfmjvwzktD034Rzrhl4l2"
    "Etb8ynMdXmWnJoDEmU8I7tkJ19PtYOI7PByk6tkpI9qAnV4WiV59By9Cmzseor9uWN13r8BP"
    "+7gqeDRYXzA0ZoCootMsZ2BUvKP2M9uLx3XTRryun7pip8cQuRjUJqPd8GELZft9AxMMQgdp"
    "BZJsbCyNqzxV7ctFzuPxU25NPhvxrwZqhYrgGsx9mNswWmZrnEhxke9VisxcsNMnsAQYAyrt"
    "y1VMd7vQPSindSFhJ1zJqEP+QM5ip8Itc+lZn8dOIKvxzyoUQnZaryDDWdHyTkjkHAc5OSkP"
    "NAqh+apOVZmF1yDUT48jtzFmqWv+/g+5YqefaF10CYxsvZWlFuaX5O4SO3VPxr+L5XTFfLeY"
    "Zvh25PXuMgIvqqTjkbAk55XTXe/nJoyufD33IoHn6IkaBCx24+LNslPwaTzH1Xb3MC1w+YvK"
    "Mrkz/uOgunp7DmmD/lxS11QHV/lxv8LSqypM0ybygyz+vHQXGuRfH3aqWtw/rGL7MTtE77tu"
    "3Hc6IpmxoTAAEbIVvIy0xS748i2i7MUxR+N54BHyJkzzjo75YKeqt0FFSRunYw56kZ1aA/7c"
    "ae3uTuDrrWcQ6kU8HS45i2GnK5gXvuOzUw14Iz8SKoIGgJYzudctuR8Mx8GuCn7PLRi+GUxQ"
    "qvkW1huk8c82slu+2MkXVFdMKAWskl6DD2MRqZFZhHHPjpwa0B/WRg+xh6nqJXA5Uh2UyuP3"
    "naFd4UfJHsiRsuCfuDeIx0WzEfrdDDvBDdu7CxHbYLlW3tvd816w01R8jfCCuRmLnQqH7MKD"
    "iuCenV7Hj9W+8LETuDvVEvUjeHFPtdSoU/TCXnmgn1WwGInQT9KnLnh1ptetFgPPHxeaBaL9"
    "RuN1FuUJhEenv1UG64WHyXVtEGqDQe/SCz5CQbDTxwjtlx8cTxHXA8gV5VC37ESPfPgEdr7P"
    "5fusw61osTtkM81O7+Ejb7p9mNnkFPEhIiMg/fH47ZSm6wDMhc4q1DzRsTD2sM/xjQ0jtLjT"
    "QBH1fQzxi2ozc/CjDGcLYojNjca/zq3gAmWqgT9QMeUvmJ63MLFe4WP44FFhH1ibquadnUCZ"
    "8QfbnIN/9Bo7PQEWweuN3d4JfB2Pm+Zm7as+CJ3sy7BT/BKEsqtw2Qkc+/9HVVsbJ7FMoK9b"
    "CayiT7ss2IZbsNRdApfqIMXFyFA8YyfRdv4pdbAIrsB0cVR8GLRj6vdJCPXHd646ypXA93xG"
    "PQrGv7elj8+ALV9bkPTGf+5S/nwSNGxB3CUWaLuvluNy0dMIZYW5Z6dhoEqE+SYIbIinou5D"
    "dpplrHy32OnfwU7HdN57XHZ6HD/Ws4WPnZojlCyt5WXltCobYHU4ou5raF7xmIf7TN83SlNU"
    "vSZ96oeJRlqkXkQOTix3NISpmWMnjAR2ylH9aUqbFzw6DeHZMQeljQ7md8V8t5ijCI3VKPdz"
    "bR3M0eS7YScBzF98J4OnELV0F0SLnaOJYJadfC/ikd5tGHdYGskLoAZ7XDsIE77kMdEKqbyo"
    "VPmsvFdgeN+Nrcz/+uep5uN/gJ0G0WAYX5P5Te19SOeqEXIHz8vCg0h9s3yAgDWCYnCFH9+t"
    "JJhEoFLgVb4gz+zUHMKgol12kHyxU3cw/FyOcX8nIhiVy0XOyupXWxEaqWOnGg7SJ45gJ9Bz"
    "ZlbVT31/8K+7VLXlGxVcxy/4E/7zSwI9lnuVnapgAkryYxe8kutiIKaoW74Ebtf6CGnOA89S"
    "XafEVUxcYraJMimYYEiL2a/4h+9JH4tfwQNaY+59zwEftVZ8LgpO580jLDuBa9U1SRfuB/V5"
    "NM8+osVfWXD0Vs71Y3N62PTwEfPZgWuZ55Z3Y9XV1YatP3PbnrR+OBnTW+OTgzfST63satOz"
    "U633tpxPv3t+zcBigstBsPaUf26mn/yVCdSUbybqvd1J9qSNA4O9yk5VP/nranbCIvltlP9w"
    "3x17wvIndSUNLh7YfcHxm/bEPR830V/MoPKIatJLxfd3XMxGo6UX+/jsv1Oy7yZs+KDO/cpO"
    "5zlEwmGnONLIX3jYaSRCv4gfFjBrrqYQ3hTBibPT2Ol1RX38qS6WSWo4eOy+FmCKnTCArqHL"
    "4nlvGtk2Z+diHpgdZbSMyW+LqYrvpr708TeaNa7h6xb3jJ124eMPcY8AQZOPJVrspgim2akj"
    "CwJceZWYfQRhmp6dpLi0V0iziiCUAyVFHqsv4OnFGR4t/vADH3u/srnf7if9x4QJ+K+JenwM"
    "WKBL7ddbcv49jdA5HxcAsYN4WzCrf2ueZTqA1a5aXtlpBUECBcBO/SBS40wlE3cigpGwDqEP"
    "lG8ecCJHGR07gZUptw6HnZbJ8WKUVg4uX4d7XfBUWuK6YG1uQXB9UyJKeiJl6PIWO4l6wKfI"
    "g6D/kS2e/yMWc7h/XRMexS1Y+R14s76gFQMr+Z+4ifrgsZJWp5fCo4ldDGsWFutV0LIMgOH7"
    "LSMuWqnhuiE7vYwp8Hw1QqWO/o7MU79+aJmWPuL84wx82KareTxIQBfKL8hVY32/UWjI7wMl"
    "PPhoDMNO5RY6ld/fHqa9FV2ojG2y4kRyuCZ5ComEhmbJBy814bOQkb+TqMc+XI79vfgb30nK"
    "o3wFQ84w5RqLbYLbi2PpokXRLi9vqvKMqkks4ydXgKgHf/CIVkPbHlQ6pCrxnHlEPd+XdHuV"
    "1iudBaE1/kfxiPG/Q/bNGZKS15fWy4cckRcXU9ieAw3ySYETBRHnTv9owE73DAlNsNNCo3AU"
    "+cbButRc4LATZbMTV6Ex2egKN0p8M3IRtkGyU229JQpPLInEn6VnAjvNLF1Q7DRU66LgR0GM"
    "NKv0oOSOnS7qHSdkGYyP9Ce/mIjQ6WDz7PSVLpScJ7sRYU8Qw+y0t+B3C6HL0sd38YFPtFJB"
    "8PbLEc31AtV4Lxhezqfl9zd4WSjcTWsI7ehvYj0M3tsJ6uLsEdwOBnDvYh5CSZHMNTKLSN24"
    "rRu9k6wbsKVrCG0KgcAV64M8spN4sZgCYyd4u+hQlJk7kcCoG+Ej9xGsZfTsVMFOhOpr7BSQ"
    "wWuW6zVXH+a6ryE5pjUvBTcSy4jj3mWnXkwmAhiWzsjYPYaw3S+A+JowTBVRmtIalSUKLpDM"
    "5G/rFe/QmA/CerI7eOxxM6q1zkFU0DLDRS8hdNPfNTv1xH3kEBGNNxCzyZ7wvE4kWn6VV6np"
    "v80y7RCZCKHFVc50IuaaUn5clZozGyeTv//Jz4id/JZqX12vynLFl9rBOzU9YadAOG18hMBl"
    "JyLgebIgfKH9NU9we3E5akiRxDomKs+wmsQyi+QjsHpula6rIvPs1BDR2aeDMSddt0leHBMU"
    "bBazrSm/OCMvs8vAy51AmgBOQBh6VSfd0v0S5MHkP8lO3+GPATx2GqXGWM+XKWoLA7GUFSjr"
    "QRPsBNZ5xgrzNjmLBY1KlWx2qaOCCoadtqn6oDAIZCOOTNFznRt2qgKGCK7m2O8QfggyIKxR"
    "DnK2FsyzE6aiDJsQPWLXFXvyX1MMqhaG/KuayjcKr2T+VhUv3TRlxwgOO3XwmJ1qfyz12dS5"
    "j3iQE7rMECk5T/bq7m6y8dXFsId6qDd5FqFJ/B/670VUCCbEOC+VLSwLjQECNI5XfbTx4ooH"
    "LCO20q15ZCewVyUKBcVOoGxAuyJN3YkERgEpCD0qL8UTwK9Iz04Uu2vsBNV2VXfW/lrIBHPd"
    "dxW9k3HBddyCwwi4ATUp6ulVdgq+jbsnsVvCVM3CJrREmmr8kojve9RcuqXApYg8aWQi7qc1"
    "amIyTGYXB4BVH+H2j1cbWbV4N10eZqc9gYbsVDJXcwfj/6YrHiq3RZCHe+AhYFtIniaSw2Mf"
    "LRcSVPF50LvZG5DTP17d7nw2KrDyW2C5vqwunusDD18b27S4Lar9pGSltkeLWSJiI8KafOVA"
    "+xKImagmRMJu7lk5KLTe2FtK+goeO0GLdv7QvGhYwyl26hRwM3g629g1KiD65ctajzTFTpEQ"
    "K7IkUOCy02KEfmlbLKjut3goya3/Mr7G0yUDqk7MJlz5jC8uhZCuf7JUYJW3IVNIckn3lWdY"
    "TVBmOX6Jz0XbyvR7U4462tCtcpCtdMsRBz1lJwHPQ7nEPNRTMYf8oXnuiLeihLdVVMfgR6Eq"
    "2mjFMiUtKi6YQyg2Oinasf8kO4EiM5rHTk3x8l5c99jwegE0lC9QTqa6FWRyZffstA5TNnO4"
    "AeEg/PwFyVe8LT7fhecLgp1KONTeAEz+F3FooN6y4oadPkasBVLRNMxgTHZgsftO4LPT9P3X"
    "c26cXDyADPLzz8ILSp8B6pJjDddb5gtEp5uYDIl5ZDqIuYaXrVHaKv4H2manhlCbZKeyww5K"
    "CLTquWBP6zzmQ0mjnTb/URfhfbWuUGY0PHvulhEtfMTOlKzzvz7rAzMHvI7qdpRBWFc/kvTQ"
    "goCZKqOoEUAEb9ZUR6Ix6TdP2AkaS1ZQ3tjpXUbL4U128hEtApvCzN2JDEa4yy+SvngMz342"
    "HjuVvovPqmMnqLa1urNClOMdH951lykehcYFb3ML/kxGpoHxOXtStBfZSfieikqw4b7iUNRJ"
    "sCS/LbXTykhMJzxZ7T3P6SyPYJvfDfmndDs1RODJ0tEMApN1ISjS4gBKJZcztscJf3IsveRv"
    "HgflILPEbI8BZVOQ5+Pi/zTXgzed2qsXmwZeqUg9MWIPERoZBinxViq+q7YBko64Oh64HLKb"
    "VlyGOreD2ucf/BaVXPIVj2M8ashfQNbBxJItmw2b3CFPId6MUx65yl4mjKvu2ak8WJ2+9BX4"
    "7IQcL2ggsfa2kqER9JOr3V68Upr2jiN2EJ3duPKMq6kvk9f/aSpGs9ViPmQYstNQOqsd+DY3"
    "kpfTStyMRD0vqcpOVFqb3ZLEBUY1eEA5DSOYqYlYnd8xSul6Zlv8BlPK3l/s5ELeU+aK2VS+"
    "OkFyk3yPx04wFYl6mAESoxa9grINLA+lxc1DzrpPzZCix6+AbMUnohk+S3IPKUcBbC6ys5n3"
    "2akPQrdkRXg7Zjx/jkp1aYKdKt7lZkoKq90fVPvrAmmLXUK4ATup+4Z8o82AUXACQnOMLtfV"
    "Xz/gOmMytIHZcduz0f5hTT7BM8BdJWa9Pbi0aT97koymNMNOEa9sFr0BnH++UYxnkUOG2SIV"
    "DXXst1Ji2eQvmxpUZp2rVEb+gCSUW082bVxRVljlZXaCatNmPj88jt0Uve0G0ZpDYrYMqdUf"
    "hvo9Cvd9TWvi3IOHX4Zqd/OYnVxeLH/slCCujH4NNHknMhjVx41NUlQtEdmGw07iyNmWZadv"
    "dAFqYuXCPRTjXLeiGmfnYcHS6WQo6GOil0zu7s+eq+bjJXYCJ89jlH1NywewCUlLRbFebviI"
    "/eW0pqPvQV96ttQ2v9Pf1KP465Pg0rSNq6adT/mJ89hpOCe+cDwq+N0+v8Q9vTo5lauJGErd"
    "1KZKwOFNurXQTPztaAq8lDnzTcolrFqW5sTGTPzzSNp8RscVanRPb6JNuWWnOpep+FwdOymL"
    "KlsCZajbowWlG1/8azKnb+QVLSLFuPKMq0n842dqfW7Xh1uaZqfSOQid0FbAYOOVoBQXeE7q"
    "hLiT/q4q7BdqWzb5b5ejgwMPqG6LkpFOs6BXxCdcwd5czVt4ndmS+iqZwHEX7NQScZOa/T+z"
    "E66dd8UPJyTXLoJ7MAHkDA3ksFNDO8p6OyLyHbukw/3acAaoIu/U5RaeKiCOszleEJyVRybn"
    "D2puzMgfnPoBKf/stEJNtyAS/TLG8LjcA3by3UIpbtX3IW0qMcKPttjJXtzxrvKKn1bRtCbk"
    "McK9fU7LosG1JwCjnYvQ3QDA3jb6lganaGdbr2IVeGzkaleF6B51LeOWnQK7LJP8I4+Mqsid"
    "tEywEwxKT/0irq/QqXG8bUhBTYYWaHXWRX0XrdQdB9Gpb+UTNyO74uOqMqC0g2JENvF0+jR1"
    "EII4rnc9YScRIGK5p9XSh1fibR3i5mKCYYJsM+wkynw/sxSngNF+2UW5WJbo5c1jp4hbqlZf"
    "YyeDJ4H2UVV/3eKgMLoS4nnBMFARntSeaoTqYpy6fkQlb7CTmKdJVbWsoUKj31dX1nMkFUJE"
    "rpLT6bgauqpKEfCaRCd5drJvpXtO42asfAexHpE6LqqO/677/8BOZZxq6gVpKm9I4pw85/sn"
    "4kldN96HpiGUpKq9fA5qUOBzig5T/x7zeyBv4g/H3HxJc0TYzXDFHbUPh2Roo4A7doq7jUG1"
    "p2DITjdVZTpQvqZJgedt6ebioal4rC5KGfBmuqk842oSyzgIbeQPPGO3eXYS23Zz5fuRKpb6"
    "3lQ2dcSIfw3/lyT9IpGwl5RLkdQqUCXn1AeEfGItSJU/m9a05FnWQV3wt3MC8Tns1ECxAN4L"
    "wYNPppnf+d6SH7gEIjO9idJf9FdbsES/F/Dj8gZUqVA9DR3oIowQRUb/dTvj1HRiI/jSgE6b"
    "4H/n1M5UFOmzlwtCG1rhp9rxcsRxssQOek+WHSW8zk5BdxXcloy4pHtMe3aDKjfsBPl871bj"
    "s9OpTr6MxW6BwGOnr1YNb181zK9IzKu7xOANRdHZXDxLjjygxyRxV7Z/aDmOVelwTNmE7TOi"
    "9taQm1zUFFFohqn68ombeUvSe01pYLTgN8dOMCr22SCFj+weUIo5VBSsenOIOluk+HoUwesc"
    "x7dNw0LqT8qCHM/iif1uo8wA0jD0sFYjdYyY5MLLAWSbM17gcMHjoBpg4jE7MRebS7sq5Jud"
    "DvqY1oApYPSWnLNioLQ9E4+dxARjnRh2Mqi2ZNU5SrtuSO1h0GrlTXE9KVjz7XOsSuaps1q1"
    "OH+v5wV2GkwkG4h2kHneYDcUWR99To69+FvO3wva4BPstWHJhbj7v4eeEW+4H+9Y2xz9jsQ6"
    "LjpOKCfuITtBUMU8Yion0qqXcij5ZR9EvC3xHqV3sBmsNfK6VEihlMSlFW/ih6zvk+jZieQK"
    "Yq8ejOYJ5tjpeTzk3WknGLOTlncC/Bs2UXPCK24u3o7e5QjcsS+6qTzjahLLkN7dU1XVbN7Y"
    "qRs5deAG5YhSlQjS/U9C6JfgLDn5YwxlSXkSj7c5saCVzdbMBdE5WsP1v8KENsMUu5N0MhfU"
    "xjLNBDtFck37fAkpnc9WnsylUr3UQ/Jk8zQnZuU1ZY9OR9qBGdQoEP3ZsfS7RydDdfvslpxK"
    "GiTJO4upuYl9YeSa4Vc5gdzaCrpKb57FTO/1OZNJxO5iL+B8s9OTRHqpnogOAn7EM3aCvUB1"
    "rvPaEH+qLWWxu1qcy05k3WQQPjgtxHOoLRC6ZybbVkBfeot2Pmr0F6lmmaiu3iDBk7KULH3E"
    "yMigk9qTEqSA4tltfb0zKke9I91hzu8vBDFmArTMl2rYKX7KYi1X7s2xGerr2Ko1GchMf9FH"
    "06R/YazPudwl7+y0XX3bhYmdchF3jeKOnSIzpX3B/5bcGLjsFIrHlkO+ptgJzBTN+I/yuduC"
    "D3EL3qCTt9p6/G7X9mYekn92glaTKu9fOYqeyWx4fZUKja+84hzypTxr9uD1G0garmUUpyQ2"
    "F3GTg+O+e53xE+dy0aeUGvXesdOfmj67L5UDT1xCpPsrShS9A/9oOoS9vtbIgYFIe30dzceG"
    "nvjH0M5jdRiu6EfZEFJNsdNgyOfVQHDBTq+RMwS4+BNXH+Lm4qOZtPdrZAdiF5VnXE1UX1Rm"
    "qdn5YKfAmwjdlBtaMwJN3kYyLu2Hp4+XY5rxospBeIzC3vKXb1Epl8W1apqsf3tWv3mvD8QI"
    "/sTcLixvu5lgJ4C7HH0CyWID/0iw39wxgfQYKv93XD5b+UkiutCV9Fd6wyTem4iaSKzrlhTh"
    "nqGf5BYdnYKcH0eF9UlFuUrydEgytAhPXtWAqs5X1OxJ+hjwwYi1GApSRsT6LtjJI92GG5lJ"
    "bKLSibHZPeWRza5jtkHaFt+iDd7+G6a13qTF7jnBHTuJ96OoV+uJ6r4wqg5e4Qyj9Na54DyK"
    "1naOthVpNAYG5w0qn4CjBlrxSETgA4OvidZAlw44VM1nrXgm0JsDc40Pzujens9VPFuS2S/K"
    "IbRK+nSIWLEMV4stU1xSpDalPEx4BqlBIGbLgNLtvskk/IM9t9n9Q+mdLpgvqLsYl50u6C2E"
    "ZtjpAsw0nHhEN+wEaj1cq41k33ouO4mxEy/Q7PQzv9oyKdMbIVd6uq7vTDXBE10we4J+qR3c"
    "ZuTiM/LxwflmJ3E476uqWSjb2AZZG9YLrxpEeOwil5yh2zJRPIbUVE4cCGF3ZpKeBTxIksu6"
    "46KHEHKWvVfsVPy1BQeS1eCUf4ipnNw3GaIHxSF+Fjc9C7RtImQowKE2cvDOd2DJzc11OmUb"
    "7DDexD9XuYJMsg6aK4jpYz6uHhPs1AZUN8crCq7Y6UnKNPK2+ldlLc2e4cXBBYKwwoh2rFau"
    "K8+4msQy3Un1CviB/vlMcF7ZSbQcP6d9VBAmRu5GxXIhccsY2cF9haSIVit/t/SiVpO6pXaa"
    "49pG3FWZJT1sbrGdnDD8Sj62FrpeoBl2gq0Nbw6NoZ42aEKq0iq3dFOSdvS5np9096LspRJG"
    "G8vPiof4dv0cLBly+q5VbnATLxlJiRsoo7I06IpLtK7qXrc+mLtuiLwVA6/5QiXlNV3Un+V9"
    "3ljyIaPzLkB28k0mnInz5SveIt1wjyqokyGwW0t9zWK3UnDPTmK+xqnSR8h+QIIdrBLmM89y"
    "kTKmQyHIMq70qNLgbKJG8geuJt2qBhH7+Lljp52VvT5K+wzJYuq1CrtWwWPDh5IW10kktSji"
    "UIr9rC1iD5F2ul9IzxVmtoy5goc7Gfg99hUXU3m1yBs7fY3Y+AyKUfKXo4APT+7YqT1CKQHg"
    "yLBQMGSnAPzIZ2yCe1/xYNrlW95MOHnf911sZBUYFCzDg64T/DzcQpn+ok06p2q+2elxdXfD"
    "VohR74ySu8dMJYoWdmKpIkMWM1VE4TVKBj58wGbUgeL4wzHKbim4YydquCpYdgqbYqdewDli"
    "KidzIX6hLHRXqJl3SVnFbE13U23kSzkD+DjexA9by4RxT8FmCSfKuWInGCB2FBNcslOcAZVU"
    "0pqR4cXhhkl9wyB1IyLDyjOuJrHMY+StthPdRDO3fNAuOE/spCmbSBWUuN0QqBGewRO5aOeA"
    "2FLwgqKGxUqix8ZlysvH5ySuT/ETJIdZorcsnS2ht8ScqC2YYSfhEwe9MZwgNDxKNpmkqW0j"
    "g6q/sS9/WwUpS6QtZn53SfZVDsgyzNLXFy1oNEHMdsYzZsyWTO9ROSi7uKJ/lCwgjTVbZt0U"
    "BZ58zlFqcJKdHmG//MgwOXce2Em/LZ/hQq4Rk6NggAc5Curf0il9aIEpbZVqsbtVxgw7PYGP"
    "HZA+RjKGgJbUPraiPMbcvhS5o82iZYCk1DnGd9xdpWJWlYbsOb1M652Wd/Wq3qn6BL3e6UEW"
    "ZZ5VkijUQyhN+/qoUuwPtRabEotkSXf4uxFAPKG5H7yrvR5zCOSfqWYm85idRvC2LPIWO4m+"
    "mzouccdOAN7dYCxta8xOotfrGxQ7vctNygFvL9XXZd0MMyx4m7nh4OrdwWEitZnR8ucDpE8J"
    "r2eUcUTslMbn54nlMESZV1P0Bm8yo4SYduqU6px5BKFXpa2njjG38zsYfL4yGG6M2Alqg7NZ"
    "pZ6LZur2Gi8gdorcy4ytF4ipvB2z0I2VVQ5IH6OwiflWS1y00ThLDj3xG58ij+yEmJS53mYn"
    "9oZfVa37hpVn/hlhCNyiBGKveCIP7KQ5OVGuT6AEywgSlRwz8fCWKqpaG+v24oWtH8nNKhRN"
    "vzgUTtbVbGtM4Ldq6ibk3GmcpQWXnYTmJ5jZG/ehxE+alwys8doGJ5m/9WMbO+MbSyUDVcUq"
    "l53igmnwEOPswpYjLUiRVLM40Uk5Se5WtVKlAex1QsnY8JYMT3hid9YR8mazc/00fV3/wjU7"
    "UQ4E4UifG7O/OXaqAVFhs31c3AdsNSNvE5xDqvpcsVNpIoHgVZpha+qH7aVazg1Zv5WOWxSB"
    "/N8QCf+wlBqy/lJG6vFZcZK+vYaJ6q49WfZ3mtXGW/5Og/ZJ/k7regUxQxn1vl5U6ixWTY4O"
    "skN5HVdQdpBmC6BFzdSjm8gTVRUV+JMlecJOMKpkBOaNnWJ5uTG9xk4iJrBKNHfsBBverOuu"
    "OHoasJMfHsYuB5HsFMtNcfmm5ihoVDcPGRbczikIeHSpmNHrmU9DEJ9RhjOuJpJTyRFmyQa1"
    "Fo4XFZlUEKs//ibNXyijeeh8K6pFX9Cvl/qLPoohp7luGkbs9IiDv6GknovAPTP8XrATWJPu"
    "zuxRv2SwnCP6Qt71Tnyl0Sru7zkT/ypv651g1ZPaqtDpncw9o0RPE3fKG7jsquo5O41UrKNU"
    "yJ2YyelRcYEAs/daMQ0U7jVZlL3sATG/FrMjUmSGuL2YEIBnwVPUJFj9BkLZbXkT8l+VzbHT"
    "sEx29o7PGqsEsT4w9aYyyO9qoZ/xPWSnWbw9j/LBTkIA6KVLssf8Dsr6oo9Ucu2uDHvvIzVL"
    "MV5JQl1fqAy+vCs4d8P1FZ/F+IoXIDvRgSsQXRxBK4vjTLFTJUCKn1zjxDqVCE3rzAJAky9/"
    "3uyOnUpiwk+nXNPqML95ntgTTFcNt3zMmdfazJLi7BIm18+3TjCs9x+SRnbPwFL6oYx6X90U"
    "pwO+3qmhOjZAhmhW3jMCiNWqpV7cJqWeB+wEzj+bhbyxk7ghSa0CYydxPmWMgm7ZqZIT5R5Q"
    "fDkM2Em0Yg+j9mTJZDx+Vd3LaNd1I1YBt+BYXsGlyMW4BqlpUJAbRnmF3u5EbmNkRg9IMw8b"
    "Ar/KhNsKUqbf5jDCpfqpXSlJCmqhd+etgZvR1VKSU/ihAJPsVBn2NdodaIadyLDggmSnB8BK"
    "p81uB2h28tDfibg9wllptvEK2aW/k78jv+zUG/Tc6W0LjJ1Yf6cPzfk78avJaPfikDbjRNVg"
    "UjSXnebQ7HSFZKdyuHEelmxGZJRoBdFDpDxCThiMh4jRhesZM1aAHHv0Gn0z+GrJ/tJuQ8PI"
    "74uf5rjl+pfqABvHHvc3w06QjDRlcEwo8dWPpPk+uOcv5+23j333CG/G95CdzNCGR+wkds6G"
    "HH3RL8oqXw5C6KBM1AMoA1AsmIYu4qVwLm8dFsdzGV2v5CjwBju5NhfRTqGryQR8HuwFXAY6"
    "46/+rq/1s2qJNM0WpN5pqt5mR6dyGkLEd2lKgR3E3+2ZaFdtQHAitNh0pQV2XS7ndxqZr/xO"
    "Ty6S8zuNr8ptF1Q/ekTxdypGbuITniOfeL6aPa8X59qnjQDiJy0sZBmi93VxBx6HNPcMz/cC"
    "/pUToutFdhJ3TSaCg8ywk7jlLcqt4JKdfPAkmhJO7gW8go7HVsdmpVsZ1s1So4L1eAVL4SWY"
    "08hqJ3pJRbthFLDP7tIpuRazhZ4UhJ16k85IMRnzd9o+21FiK8Td3kktK/33KYqFKTyXNj47"
    "hUDUwZWyghl2ItPRFSQ7DVQy86sjIclO3FCxoR7G2Y1i1eRG7DSWNhLVRvllp7hoMANldigo"
    "doJn7sKs0PIXZxfHr6d6B9ROxLITxAJpCiM/O5XGW04mzqQYh63TD8PlDsm3kBkEEaZUeqVp"
    "UppBlE6v/B6Umgtu3Vmka1Pgn1yvRnng7WSGnXDfsDOeUb7C/6+ckDNYBWUZG2tkdupHKfYk"
    "iU5FqdEMO7VXkh10phXQUoZ5VmEuS3nejHUUoTPmSTA/7MQk6n2dus36mgHBNTsVhyD/De58"
    "gDarG8+aZicY7/+WPz9MB/0N0EWqHiV2wtZGGVbvxEWkDw2ifwwl4tUtUl7xba/nLa+40GL6"
    "dSmv+LQHTV2xsvr0RwnHucHyiXFFXZVV3lvY7TBgOmttMJGD0vod6SN4UKZVMM1O4FyWUyWv"
    "7AQWwjtlC46dRCMXBU/u2QkMUApaG7GT6FA9nmQn8KvOYHI9/kDk9jCsm4cMCm7lF3xP79+n"
    "CqSOQ6FuGKUEjPjBbF+mkhv0Ft3QQKPLpqhpJj7RMSL++hRCb8LgdZj63QdqGsQg/GPHg6bY"
    "aTFol2MFc+xEbINQkOz0BWVQi2H8nbgpipp6mN+pGdL5bvHZqSM9Ab+Zf3YSSkMm1KynCoid"
    "2tH+d17I72TATkK0XUnK1Jphp0+pZtEQUewEXf0r3dZ2YtRo2YXyjfjg8bltKyZqCyK/cx4C"
    "ndZhOs5vP2xVU5MN8IE9DpZx7RkNeEDAYaeiPM/Q/18pg6sgVG4Yhl4eMjt9oG02r8ovalTw"
    "x2oz6a4oOSKy8SxEJNttL2opzvA3pLym920PyNE56xcUOzEbREU5yYj2rzgbT/HYKRxm5x3u"
    "9tsskonQXQMtvtHYt5RoYRBik6aZxLey3t0P6R2giubq/Z2m8FrDbYRO+HhYdeWG/yMFY6/s"
    "5vFuWTUnyvvZLehgUr8o+N5G13yUWdQhu8g1vSu9js7pajOogl9hInXSN7RoSd1EnqSF64rQ"
    "tYmphbDRBgBQKpFIjOc5O4mvb6NPwbGTBE8fesJOorGzuxt2gh6TWoJgJwFSuG6gnuRhJxEA"
    "Ylw32/gF2/MLhl5jw400aQtxzG4Z5TAT6w1TGqKi90LwN9mlJmt2Q02flIo7b1kyhGUmQktf"
    "ZDdFaI7nwjNyH22KPx8LMsFOEDhgoIDhcBGx/WZBstMMSm3xJcNOhB1imGqehb057OXZE4VB"
    "wmx1WUkmzBZ98xuYYKciePF9QePFnV5gJ6EEaGyynykYdgrBreVGODGPGuUV1yrPuJpcshPk"
    "Y7OrJEoa0kDjoT3eZzQ7QdO/bmvEmiHAIv9ykuKAvAQvvsaJfn6qVLgpmolCj+tSKb+KB+Uy"
    "X2g5idWmuZe/2alvJseHh8NO9RnVWCGQngjtVB6PTVsljG1HspPttLbZPGFA+cdPPdNWdbT+"
    "XjN/bLDRixh0Nop7J2txM+Mw6bB7wk66jcmXEbH6VfCEnFrSPTsFw3h4MMLdtb5CfCJ0l98p"
    "ltR+q4FCsLS5Q11zNof0dlMrNoiz0xzRNLGt4wU7mpA6n0gG4Dtz2nmgRy0zeL/kHb6mhyf7"
    "u69RfAYiMUQ6vmkSGlRnYjrkFe/85G9EOsiJOjfponjoTQ/nTuRQwblKjLnoBbmAWtPXPBLP"
    "B4AKgMt3quSdnarDxRYGFBw7SfEwEz1gJ3rZZMROoP6cSrJTLVAr/0AMEPVukHpn47qpfpdX"
    "8CejgmCSljPNxE6nveP+0Gs8OIwCWT1OEsrhjxCdukYmhpHJquWSEOgin+N2pI5qmJuuz2Fy"
    "IIadwS3zIVKZO8U9O3XI1aZWE+wEyDmt4NkJWo86Mjays+xEbcnmkM2lQ7n72c0y3KgN7IKH"
    "QtyzkxgL8I7yRxfkDXaS4ghzehQIO4kJOFQtUkSiq/3slMqb5XI/O0N2Oq8EndRk8rE2Is0U"
    "4ta98cxL6TyNTeVcEo+mB9X9+l5HaPc2KmmPP2Dr7/ju62exjn6heOE14Qa9egft1sUogxvH"
    "iLbRBDu11PtWFZyY289upmKMjxdjbdmWuzBGZafgxUiXXCDgJHIqmrwyDiVHwQEVdB+Aqt2o"
    "zEll5M0xD3KDKgaT7iuSDDBcj5hmpzjDEVsavuQyL+H1KjVZxuBVXaY0ZkTu5rmX69nJBnaf"
    "U7x08FuIHwbBatbR2C07/dpZoxAxr/hqbVWM+2COXMM1k6iJUV642FnSA69XOr/TWWXwn/iC"
    "cqFSa2jzn5m9gNUFUqsZNzzNrCVZ9Xa+VcLVj/rqnLdeUaM72mdrudqny6kTh8njkW+CEmiu"
    "yQK1/zHzsbjbsDY2iLuMbmukQdeELMRlp5A34KFzHnXPB8ZHuoqxIURGH9tQ77KTOHdrsO0t"
    "dgJnxMzb5CDzmrj5sGqA7AlpSY6HuK8B0UTGFjxRzKhgUKLqIhGHUidpmvCQ2ZwGyGEn6D/o"
    "d1Ud0D9XjX5SBRbvGfrNBAQpF0MGOdyDY206s53VTKpTBvyDO18Ld+z0ACzldwWYZ6ehTExh"
    "wbATmKT3yWZQaeMIip3Q19LoEbGH0ECEnsR/rFSiVWxvD5AQGU8GDnnYap1BQkEQaAJ3a0aj"
    "Eu9/ymenujl4bJN1jo1ue4edhCI7yMHRu+xUKU3bb6bon4TZybjyjKuJZac5g7WJ9HV11RCQ"
    "TSeshySLSvOudAIx3RxscWuvI5RKo+tB8fZkF9mq+IayqfX4JAgPFofttyDWuhKjGoBNhQYR"
    "2IOfKLWui4k73gQ7sW5chYCdzsi6cXB3eoDDB871A2qH9UUL6gyHMTuZmebeJ+faJTJadcaQ"
    "qXDIC6B8T50aVyKgStd5EIlzHQaqbTzbTk19YpMVCCWZtSDlj51W6oJ3YCTK+rRWcNneEF54"
    "MNQtO/mCC3hCRf6rOPdZtxrF/IPLPvLRJaTf04fHThdQ4rTna0b6h8e8JmZwvUjYozs6YC/g"
    "2CJBtcfDkn1vIItJOrWWnxgVsaZzlH9YwzFg9HA+rT3I+XGxxW1RD0+GwWh3SN7YCTptpyWZ"
    "nrLT8dFV3PxIz05F05BTjsvqoOxvvKOCGFHmXNmIHPNZtxhIDLybnY9tpdpNh5aZToQG9YH1"
    "tXPdgAZRthJ1X1h6V4tBU8uFl2/c70cxLtbeywQhuSIH0ZL95/stK4b6R9Ts+nWimCbXi+wk"
    "KlZUePIaOzWWc6rQOgqU+kOHioGRdQaIuzCer2imBsSAXKZgeeOCEP3/j4/SJp1bRreuGBxQ"
    "qvVEMP0wEXR8v6JYYO5rE2JL+hep8bJ4OV0+Nml3Il2qcMkZFlExueepbNsgsI/dPkLd3gBf"
    "71Sw6/sKBX64Ei2YZ6eqTHhawbCTPwRInXgx2r9Yq2+z0Zl9NDvhEXpn11IBlfpD3V9Wp/L6"
    "MOdfG9sk0lb6kUnJSgMCfblzTosioY2nOdBfROIiiRszpneIsoWWbTNkY47a4xl2Ep13cr9v"
    "ViS0wSQ7dYp8sJMQBu/C2a8g2ElMhIbWdCwZWPktWMwll3RfeYbVxLJTPLKvHdgyKtAW/QTo"
    "NXKaqPpINK5qAKWBsH9SKzC80YepaOslupv7yNuGMDuKfI7IIeOi+JemxXgM93xHa3WORrtI"
    "tUMtKeFUpPpFWTxIOzoK/zp2Ko9X6iHyrV3iakxFo4r8bwqjLqmUgW5oNFXuJnJ+VDrsxTvI"
    "qbkj9E6n/ITXluwN8LSK59xymM2RB4mQvjL7uPlip+B0NsRYUlKou52VoycZSuINvtd8F5iv"
    "c8cJZtiJzqZMBf2+SqYC+4d2Nd7FtceVPkGdzjlA95JF2VBEyDM7wRLupU2tzLfQnz9v7P5H"
    "enYCm/1WGakj3t9z035pdU9fYcy1I8veJuh/CRMErA4Utfgv6y5lsm2VyBzeXsfoJe9v4qJt"
    "qPfuihyaXWQLORdW9CY7gS+iCuyce8wbO4l2bXqQeZnu7eh/pUzRoyD0SqMLrivuomDABcU5"
    "LU73KD/7m2AnoXMqXWq2Lj/fEGnrPH3Yh5+Y1gYRzXye+AVhPiuNFycZVNzNGH1uXfa+4gwi"
    "K8Ybc9FR2h2rgPI7tSayit+sw+R3arNMO5hCqBZiUziJLn3mET+uSs2ZtU/zt4Fk2cl/BXOK"
    "jV5gJyF4AzEkepedxMBMVRLrCO4rz7Ca9OxEjRlKAsJuzMzku5XYSrUUiypjEdueQZ4Qv2yt"
    "KLjEW1G1GNHXCEfAyIvs5gXibc1z1bLj/hXs1FsJIBuv23QEdKcjz5BT/lJ2VfQbbYJsnCz9"
    "0E7u9FtznXaGI+Ch+YqTszqUteF2ypr3FC/xi4fs9Bgdz2DATnihmBXGTrTvZCr3vbKk4EV2"
    "2tpE8JSdbn/KrFpbq7sM5vxA3ziE1F3gOB2FfkOMgcdaCzx2ujHQ15g7XdVkAQqHnUrc4Hu6"
    "k1IcP22aTlk4WtktR/ey1jIJ2oKHXiOO7u7hw3/JORu6+Ar5ZSch4M1LZJGU6fVdAIcLdnpA"
    "ycKgK/aJNoV5j51iHCw7CRUX5GinPdvXx5zmDRZxc4mCp593XRAW88eg3n0f+fEm+SBnnuP2"
    "Kr0utPpKYvVx8gX9/ZQUzcFfc+5U3KAqM5C+GyqOf7Vmp1Gm/L/w3Pawt9npY3rXrYLak+VR"
    "tSccqMnmxoyzfasc3EsFq1deqlZw9teK+dVvomJkP1aLmTMjvsgg9jqcUMqAnYSAqfLOHOho"
    "LQgvWuYNdhIC12h76HmZnYQu59TnWlGB6ldGlWdUTS7Z6YyWvGEyMzOFrVG+2FhKhyqVxPd0"
    "ljHvQMoXlK7orsRsL2o+QF+IpfmfOuzF4p86ycU6BHGTu4H8W9lpjhKCE29wZ3WHLTp83YHs"
    "x1cN0VlXMHHsouq86NgDdzLPfMvY/mqN3XjxbtblPVPaSj9+3cnf4D3Krm4kKOslPJmsDdhp"
    "vIsq19hpNndP86ghWy9mXT/4TXOdccNDdirb9YOlfyWm52ZePbJoeBUXJixi7Cv51LjF+y6n"
    "52Yk/TXjRb0fZWDXxcduZSVuG8MaWj/nBAfJZxy4+OSNnPTE7V9QKpbwp6dsOp+ee/fkL31C"
    "XOnsxt/LxuuSncQ8qq+7LjaIu8c4pA26aqNfluPmmVXvV+UATdxH8SdScm6c/G14ff3Lz81I"
    "PrR6Utfiguu2YY6d8HDZ7L31h6/Y0xOPrHivvc0lcLhgp7rKzj36Yho8eY+dpPUoM8hEvbXk"
    "2B1H1pXtnzNhA25qQCj15uKjd6SJcWuA64J+YEbvrdTcyEX/XLPbU06v/vAhg14Vx/m++rCV"
    "J6/npF7cMaUjN7xhOeJlsxPkXVPIiOAHxFW/lqHjdU7Ifa0sPD+FepmdwCmrfMGzk1BkyOZr"
    "2SmH5z7qq8srjp8gZuqB61kXfn2ONSXUGbP1YkZmwprB5MKzxqRDt9JPr3rGpp8zS/VbjLtb"
    "6vl1H7fyNcAQ6bxTlVP4ZWuhCPljJyFghWqI9TY7CYE9Fp64ZU/a+0kTpl8ZVx6/mlh2KvrI"
    "iHk7LqQ57Nf3zXiC1Jw2+WpPip3srB3mn72bdmx+ax6qxCPezvU7SGe/aGqjIEgZd5WInoek"
    "IVcJT/CiTjkxlDl2Om+enfoI95+8qpu9CkTmIbSHVB1keWGyxi3jjL+7H/ledTsXW2KqJu+R"
    "gCPeWB/rnTDSTstwft+K72p9Mm9LuFzkk0TptwqMnQqrNOQEFJvoIT0Lw733NRtWc4G7pCnM"
    "8rJO7epSjtGzvhE7QT65bvdhI33l3rBTPSeVZmU4Qpfzu9VskCn+isVTcbQ1QHuhJu+RBEAw"
    "+ko26rXL/ur/7Xf0lptdqO8LCd1vFExhsRMjM6i0PP85dvpI76fjTjox28hZ7OR92YvQ3SLm"
    "f76Lk1iSw079+Gl17gOSvCfsBBkgtV3WAhN5G4p7KHGmlCWTOehrSV5q8l5JMOxlkvEZYQ7w"
    "e3oTQudK/6ffEfg1vHrfP0UZcP560epx7tkJr8Wzi/5n2aniLYSu2DwrM9DAEGuxk9ekBWeL"
    "JVcyV9oWxh07/UrvZWixEyMxDpRbgwDNc7b8nnG8KWXJSTqbmCV5rsl7Jr4TIF7TvmZQbFSg"
    "Lapun5kQAYxmFfkvvyLIxp1d4v5/jrp38JttbXU5hp2Qzu8rME1OkF4pfzub3j9SYaHqbl3l"
    "sMGu7q7kd9yyAgvDg/xr2cl3O0LO2h4UgJw6Z7uXD3DBTj7hjSCrdsL92GJfukfsBGlYlcCJ"
    "4Mv0Nop5k/jCpCy5r6XQ1WSzfbqNfh/7D7+fwGqj0ojdYe5r6ZCD0I0aVp9zx06q/GfYqRLK"
    "WdGramhAVIfpkA7jRKgnhf2rTKK3ArXYydsSUA9iLH7xpEj4DTqThZ6dlMY96n5ssX3vFTtF"
    "Xld3HHyPk6rdEkuI1UinzWSaq13P+P5360KZPC8Vt9qFxU7//nYup93zRL8hh/TnNC4UD/Kv"
    "ZCc5acKd8h6Vapdijp2WWloQSyzxlpR9dc7eq1mOO8eWDvlvu4nLc8rOslabsMTUxK2Tvvcb"
    "OzlXlvF8Zs/pU3hewb+UnTI7elis2BvLjtzIcsFOuWmXt33Zyuq3llhiiffnFEfK4R8esyrC"
    "kn81Owl1B/+093RKTurFTeNqe1g03nnn0LSqhegV/BvZyX5uphdWsRc892SzxBJLLLHEEoud"
    "LPnPisVOllhiiSWWWGKJJRY7WWKJJZZYYoklllhiiSWWWGKJJZZYYoklllhiiSWWWGKJJRz5"
    "P0NIXto="
)
CYCLE = ('#1f77b4', '#ff7f0e', '#2ca02c', '#d62728', '#9467bd', '#8c564b', '#e377c2', '#7f7f7f', '#bcbd22', '#17becf')
JET_BGR = (
    "eNod0gFHnQEAQNG7STKZJJkkmUmSZJIkSZIkSZJMkplkMkmSJEmSJEmSJEkmeZI8ySRJkskk"
    "SfIk8yTJJEmS7vJxfsLph0EYhlEYh0mYhlmYh0VYghCsQhg2YBO2YRf24QAO4RhOIQIXEIUr"
    "uIFbuIdHeAZfxWAcxmMCJuEHTMV0/ISZmI25mIcFWIQlWIYVWIU1WIcN2IjN+A1bsQ3bsRO7"
    "sRf7cRCHcRTHcRKncRbncRGXMISrGMYN3MRt3MV9PMBDPMZTjOAFRvEKb/AW7/ERn3nx7ZOx"
    "D7678/0/E69NvjTlr2nnfjwz48SsI3P++Pm3+XsW7li8Zekvy9etXLN6xdpl63/6ZcGmOb/O"
    "2DLl9wl/jNkxYteQPQP29TnQ41CXIx2O/XDiu1Mtznx1rsmFL/6sd7nWlWrXKl0v91epW8Xu"
    "FLqX7+/P/snxKMuTDM8+ep7m3xQvk71O9N977975EOvTG194lke5l1u5kSuJyoVE5FSO5VAO"
    "ZF92ZVs2ZUPCsiohWZJFmZdZmZZJGZdRGZZB6Zde6ZZOaZc2aZVv0iyN0iB1UiNVUiFlUiJF"
    "UiB5kivZkimfJF1S5YMkSYLES5zEGPR5DirdB61ugmLRoFskqHccNDwISu4GPTeDquGgbSgo"
    "vBh0ng1qTwbNR4Pyr/H7/wN46G3P"
)
LUTS = {
    'viridis': (259, (
        "eNot04lP1gUcx/GO1Wq1Wq0aID4PD/clIPctx/M8v4fwCAUBQS45RO77vuEBnuf5PZlllmWW"
        "ZZZllmWWpRalpnmFB4ogYIBra22trbW29u7r5md77fMXvPX3p6N/IAP9g5kYHsrC8PAGDI/k"
        "YHw0F+NjeRgfz8f4RCHKk0UoT21CeboE5ZlSlGfLUJ4rR3HYgsmxApNTJSbnakxLazBpajG5"
        "1GHS1WNybcDk1oji0YTi2Yzi1YLi3Yri24bi147i34FxWSfGQBHUhXF5N4bgHgyhIqwXQ3gf"
        "+ggR1U9y9ADJMSJ2kKQ4ET9EUsIQiYlmEpPMJCQPk6AfZoVBKCPEm0TKKHHPi1SxcpTYVRZi"
        "V1uIeUGkWYheayV6nZWodJFhJXK9yLQRkSWybYRvEDk2wnLFRhuheSqh+SohBaJQJbhIbFJZ"
        "XixKRKlKUJnYrBJYLraoBFTYCagUVXaWVYsaO/61ok7U2/FrEI12fJtEs2ix49Mq2ux4t9/T"
        "YcerU3SJbjuePaJX9Nnx6BcDKu6DYkiYVdyGxYgYVXG9yyKsKjqbUG3o7DZcXhRbxUs2tNvE"
        "y1a0r4jt4lUrmh0WNK+J1+/ZOYrmDfGm2DWC5i2xW7w9jPYdsceM9l0zLu8N4bJ3CN37Yt8g"
        "rsLtgwHcPuzHfX8/Hh/14flxH14HevH+pAefgz34ftqN32dd+IuAQ50Eft5B0BftBB9uJ+TL"
        "NsKOtBL+VQuRXzcTJWKONhH3TSPx3zaQcKyepON16I/XYjhRg/JdNSnfV5E6VsmqsQrW/FBO"
        "2o+bWXeyjIxTpWSeKiH7dDE5PxWRd6aQgjMFFJ3Np/jnjZSdy6X8XA4V57OpupBF7YX11F/M"
        "oPFSOi2X1tL2Sxqd42voHl9N3+WVDFxOxXwlhZGrCtarRtRrerZeS2bbRCLbJ1aw43o8O6/H"
        "sutGNLtvRLJnMoK9k2HsuxnC/pvBHJgK4uBUAIem/Tk87ceRaR+O3vLi2C1PTsy4MzbjyskZ"
        "HadntZyd1XB+dikX55wZn1vClTknJm47MnnbgSkx86sDc2Je3Jl35Dfx+7wTfyws4c8FZ/5a"
        "0PD3opZ/FnX8u+jKf3fc0Uv/d/8+2f8+s0yt"
    )),
    'magma': (259, (
        "eNot0+lTVWUAgPGLbLKee0BERcVQiRAFRVKUXHCXKKJI7XLhArIj+353XFJTM4whTWNIIzOG"
        "ZBgyhjTHyhbHynKsHK2sNMeMNDODe855ej/04TfPX/DodO7odB6CF246b9zcfAQ/Ro0KECTc"
        "3WU83IPx8AjB0yMUL8/xeHuGMdprEj7e4fh6R+A3ehr+PpEE+EYR6BuN5BeD3j8W2X82QQHx"
        "jAlIICRwPmMDFxAqJTFOWswE/VLC9MuZqF/JZP0awuUUpsipRMhpTJXTmS5nECmvI0reQLSc"
        "yQw5i5l6E7H6XOL0+czRFzJXX0SCVMI8qYxEqZyFUgVJUhWLpGqWSDUkS7Usk+pYIdWzSmpg"
        "tb6RtfomUoRUuZknZTNpQWbSgyw8HWwhI9jKujFW1ofYeE4wjLVhDLWRFWrHNM5OjpA33k7+"
        "BAcFQlGYg+KJDkqFskkOyic7qRCqwp3UCLVTnNQ/5KRBaIpw0ixYpjqxTXNiF5zTnbQIWyKd"
        "bBWef9jJjignO4VdjzjYLbwY7eAloXWGg5eFthgH7TF29s+0c0A4OMvOa7NsdMTa6BQOx9k4"
        "Emela7aVN4W35lh4O95Cd7yZnrlmjgu9Cc30Cf2PNvGu8N68RgaEwfkNnExs4FRiPacX1HFG"
        "+HBhLR8n1XI2qYZPH6vm80XVnFtUxfnFlXyxpJKvllZwIbmcb5I3cXHZJi4tL+PbFaV8v7KE"
        "y6uKubK6mKtrivhhbSE/pRRw7fECfk7N59cnNnI9LY8bT+XyW3ouN5/J4VaGid+fNXF7fTZ/"
        "bMhmyJDFkNHIn1lG7piM3M3J5K+8TO7lC4UG/i4ycL9EKDPwT7lQaeBBlVCTyb91QkMmw02C"
        "2ciw1ciIPYsRh9CSjWuLCdc2YXsOrp25KLvyUPYIezeitOaj7CtAbStEbS9C3V+M+moJ6qFS"
        "1I4y1M5y1NcrUI9UonVVoR2tQTtWi9Zdh9ZTj/ZOI1pvE1qfGa3fgnbCijZgRxt0oL3fgnZq"
        "M9rprWhntqF9tB3t7A60T15A+2w32rk9qOf3on7ZinphH+rXbagX21EvvYL63QHUywdRrxxC"
        "vdqB+mMn6rXDKL+8gXK9C+XGUZSbx1BudaPc7kEZOo5ypxflbh/KvX6U+ydwPRjANTyIa+Qk"
        "LuUD8b37/9Xp/gPfH2Jg"
    )),
    'inferno': (259, (
        "eNot0/lTlHUAgPHlEHj3hRUQEZAbOeS+BDnklEOQI0BADjnkZndjTCstHRkH00pHxqFiTIeK"
        "scuxrBwrxxwrxxxzzMoc08wxI80wdhfY47Wevj/0w2eev+BRqRxQqRwFJ+xUztjZSYKMvZ0G"
        "e3t3HOw9cXTwErxZ4OiDk+NSnBcE4OIUhOQUgto5DNk5AjeXKDQu0SyU4nCXEvBUJ7NInYqX"
        "nIa3nMESOQtfOQc/OQ9/10ICXIsIci0h2LWMUHkty+RKIuRqIuUalst1xKjriVM3Eq9uIlHd"
        "QrLUSqrUxgqpnXSpgwypkyypi2ypmxyphzwhX+qlUN1HkbqfYqFUHqBMKHcdpEKoctNSLdRo"
        "tNRqdKxbqKNBaHTX0eSho9lDT6unnjahfZGeTi89G4XuxXp6hD5vPQNL9AwKOh89emHIV88m"
        "Xx1P+enYslTH08Kz/jq2Cc8FaNku7AjUsjNokGFhV/AgI8ED7A4ZYI+wN7Sfl4R9Yf3sX9bH"
        "AWE0vJeDwlhED68Ir0V2Mx7VxSHh9eUbOSJMRHfyRkwHbwmTse0cjW3j7bg23o3fwPvxrRxL"
        "aOF4YjMfJDVzIqmJj5LX80lKIydTGjiVWs+nK+r5PG0dp9PrOJNeyxcrazib8QTnMqv5MquK"
        "r7MrOb+qggs5a/kmp5yLuWVcylvDt/mlXC4o4crqYr4rWs3V4kK+Lyngx9J8rq3J46eyXK6X"
        "53CjYhU/V2ZxsyqTW9UZ/FKzktu16fxal8ad+lTuNqTwW2My95qS+L05kamWeKY2xPFHWyz3"
        "O2J40BnNn11RPOyO5K/eCKb7wpkeCOORNpS/dSHMPBnEzFAghk0BGDf7Y9zih+kZX0xbfZjd"
        "5s3c84uZ2+HF/E5P5oc9MO9yxzyiwfKCG5Y9rlhelLG+LGHd74L1gAu2UWdsB52wjQmvOqGM"
        "C4eEw8IRZ5QJ4U0XlEk1ylEZ5R03lPc0KMfcUY57onzohXLCG+VjH5STfiin/FE+C8R2OgTb"
        "mTBsZ8OxnYvC+lU01vOxWC8kYLmYhOVSKpbL6ZivZGK+ms38D7nMXytg7noRczdKmb1Zzuyt"
        "Kky3azDdqcd0dz3Ge60Yp9ox3O/C8KAPw0MthukhDI82Y5jZisG4HaNpGOPsCKb5vcya9zFn"
        "GWXeNoZZGcf6+DC2fyZ4/O+k+N7h/6pU/wFnLz4q"
    )),
    'cividis': (259, (
        "eNol0+dvVgUcxfH7whcmJiYmxhijMTIEAZmlLa2lpS1t6d579+m885n3lrL33nuUvffeIJRN"
        "GbIpyBTcGmccab7+Yk/yycn5A47SKQWlc5pIR+mSidI1G+XjHJGH0q0ApXuRKEb5pBSlR7mo"
        "ROnpQulVI2pRPq1H6a2i9NGFidLX6tCvw2v9LV4fYPGGeDPI4q2BJm8Hm7wj3g0xeS/U5P1Q"
        "gw8GGXwYZvBRuEEn0eUzg64ROt1E98E6PSJ1eopeUTq9h2j0idboK/rFaPSP1QgSA4dqBMdp"
        "hIjQeI1BCRphCSrhw1QiElUGJ6lEiqhklSEpKtEiJlUlNk1lqIhLV4nPUEkQwzJVErNUkrI1"
        "kkVKjkZqboe0PI30fI0MkVmgkVWokS1yinRyi3XySnTyRUGpKNMpFEXlBsUVBiWitNKgrMqg"
        "3GVQ4TKpqDaprDGpEq5ak+o6i5p6i1pR1yBUN/WiQXOj6m403YNueDBMYXkxheX24vZ48Xh9"
        "eIXP58fn9+MXgUAA2w7gOAEaHZvGRpvhw22ammxGNDmMHOEwaqTDaDFmlMPY0Q7jxjiMFxPG"
        "OkwcJ8Y7TBKTJzhMmegwdZLDNDF9ssOMKQ4zpzrMErOn2cyZbjN3hs08MX+mzYJZNgtn2ywS"
        "i+cEWDI3wNJ5AZbND7BcrFgQYOVCP82L/KwSqxf7WbPEx9qlPtYt87FebFjuZeMKL5tWetnc"
        "7GVLs4etqzxsW+1h+xo3O9a62Sl2rbPYvd5izwaLvRtN9on9m0wObDY4uMXg0Fadw9t0joij"
        "2zWO7dA4vlPlxC6Vk7sbOCVO76nnzN56WvbVcXZ/HecO1HJeXDhYw8VD1Vw6XM3lIy6uHHXR"
        "eqyKq8cruSaun6jgxslybp4q59bnZdw+XcqdM6XcbSnhXksx988W8eBcIW3nC3l4oYBHF/N5"
        "fCmPJ5dzeXolh2et2TxvzeLF1Uy+upbBy+vpvLqRxjdfpPLtzRS+u5XM97eT+OFOIj/eTeCn"
        "e/H8fD+OXx7E8mtbDL+1RfP7wyj+eBTJn19G8NfjcP5+EsY/T0P591kw7c+DaH8xgPaX0q9k"
        "fx2CIv//vyX/ATPLZgs="
    )),
    'Blues': (259, (
        "eNol0/dXFWQAxvF+fCvTysqysm3ZdObeOVKPIzVHao7UFBVFCYJQgkgUFcWBoiBDhmyQvZG9"
        "x71c7oXL3ntzQdRvL7fnnM95/oKvbgQGnzxnYPg5/VLf0DO9Xt0zeqTuwad0jRp4SqfU0T9C"
        "+6i+Edqk1t4ntEjNPf9r6h6mUWroGqZ+VOcQdVJtxxA1o9p1VEtVbToqpYrWQT1tyyDlUlnz"
        "gJ6maQC1VNrYr6dq6KdEUtb36Snq+iiWimp79QpreimQ8qt79PKqesiVciq79bIrusmSMrVd"
        "ehnlXaRLaWWdpEopmk6SNR0kqTtIVLeTUNpOXGkbsao2YlStRJe0EqlsJULZQriihTBFM6HF"
        "zYQUNxFc1ERQUSMBhY34S34FDfhKPvn1eEteeXV4Sh65dbjn1OImuWbX4CI5Z1VzN7Map4xq"
        "bmdU4Zhexc20Kq6nVuKQUsnVx5XYJ1dwOakCO+liohbbBC3n47XYxJVjHVuOVUw5ltFlnIsq"
        "wyJKg3mkBrMIDabhakzC1Bg/UnM6tBSjkFJOSobBKo4HqTAIVHE0oIQj/iUc9lNyyFfJQV8F"
        "Bx4q2O9TzD7vYvZ6FbHHs4jdDwrZ5VHITo8CdrgXsN0tn22u+Wy9n8cWlzw2O+ey6V4uG+/m"
        "sEFa75TNujvZrL2dxRrHLFbfymTVzUxW3shghbT8ejrLHNJZei2NJVfTWGyfyqIrqSy8nMKC"
        "SynMt3vMvIvJzL2QzBzbJGafT2KWTSIz/0lkhnUC060SmPZ3PFMt4/nuXBzfno3jG4tYvv4r"
        "lq/MY/jSLJopf0bzhWkUn5tEMfmPSD4zjuTTMxF8cjqCj43C+ehUOB+eDOMDw0dMOhHKpOOh"
        "vH8shPcMgnn3aBATjwQy8fdA3jkcwNuH/Jlw0I8Jv/nx1gFf3tz/kDf2+TB+rzfjf/Xm9T1e"
        "vLbbk1d3PWDcLx6M2+nB2B3uvLLdjTHbXBnzsysvb73PS1tceHGzM+Kne4hN0kYnxIY7iPWO"
        "iHW3EGtvINY4IH68hlhtj1h1BbHyEmKFHeKHC4jltohl/yKW2iCWWCMWWyEWWSIWnkUssEDM"
        "N0fMM0PMNUXMMUHMNkZ8fwYxywgx8xRihiFi+gnEtGOIqQboZP+j/4Lcf+Nd6C4="
    )),
    'coolwarm': (259, (
        "eNoV0+lT1AUAxvFmetObXvSmF73pRTNlpo1ZToZnaKh5gyEhKCqBByqKKISKoUJokCgkgSgi"
        "CqICglxyLsdyCCzLLnuD3McCC3v9lmt/3+iZ+czzF3xddtSwZqeEtbvrWL+3ng0eUjbua+RH"
        "z2ZcvVrY5N3KTwfacPOVseVQB1v95Gw7omC7v5IdASp2BqrZdVzDnpM69gbpcT9twCO4m1/O"
        "9uAZ0sv+0D68LvTjHTbAgfBBfCKG8L08zKErI/hdHeVwlJGj14z43xjnt+gJAv+c5FisieO3"
        "pjgZN01QvJlTt82cSbAQfNfK2UQbIUk2zt+zE5oscDFFICzVwe9pM0Q8mOFS+ixXHs0SmTHH"
        "1cw5op7Mc+3pPDey54l+tkBMzgKxLxa4+dLJrVwncXlO4l85uV0gklAocue1SGKRSFKJyL1S"
        "keQykX/fiKSWi9yvEEmrFHlYJZJeLZJRI/JYIpJZK/K0zklWvZPsBic5UifPGxd40bRAbvMC"
        "eS3z5L+dp2BRYescr9vmKG6fpUQ2S6lshrKOGcrlDirkApWdAlUKOzWLJEobtUordV0WGhZJ"
        "VWYaVdM0qadoVpto0Zho1UzSpp2gXTuOTGukQzeGXDdKp24EhX6YLv0QKv0gan0/Gn0fWkMv"
        "OsM79IYeDIZuug16evQ63um19OrU9OlU9GuVDGgVDGrkDGk6GFbLGFG1LWpltKuFMWUzRkUj"
        "4wopE531TMjrmOyQMCmrwSSrYqq9gqm2cqZbyzC/LcXcUoyluQhLUyGWxgKs0nysDXnY6l9i"
        "q3uOrTYHuyQbe00W9uonCJWZCBUZCOXpCG8eIpSlIZTcRyhOwVGUjKPwHo6CJByvEnHk38GR"
        "m4Dj5d8Iz+MQcv5CeHYTISsW4WkMQmY0wuPr2B9FYU//A/uDSGxpV7ClXsKWEoE1ORzrP2FY"
        "ky5guRuKJSEE8+1zmOODmY47w/StU0zFBmGKOYEp+jiT1wOZiApg4qo/45FHMV4+jDHCj7Hw"
        "g4xe9GUk1Ifh894Mn/uVoeD9DJ72ZCBoH/0nPOg75k5vwB7e+e+m58guuv12YDi4Hb3Pz+i8"
        "t6L12oLG0w31vs2o3Deh3O2KYudGOrdvQL5tPTK3dbRvXkubqwutG36gZd1qmtd8T9PqVUhX"
        "fUfDym+pX7GS2uXfIFm6guolX1P12XIqPl1G+SdfUfbxUko/+pLiD5dQ9MEXFL7/OS6L/f//"
        "7y3uP+x1CcU="
    )),
    'gray': (259, (
        "eNot04kv0A0AxnEUKXJUjiS1WFmaTIZhYsmx0jElhtJ0Tq4lxxw5JpSzFoVEllJ0LopSmDNy"
        "zZGbJiQR0+H6vu/72/tsnz1/wVdERARRUVHExMRYtmwZy5cvR1xcHAkJCVasWIGkpCQrV65k"
        "1apVSElJIS0tzerVq5GRkUFWVhY5OTnk5eVZs2YNa9euZd26dSgoKKCoqIiSkhLKysqsX78e"
        "FRUVNmzYgKqqKhs3bkRNTY1NmzaxefNmwZYtW1BXV0dDQ0OwdetWtm3bhqampmD79u1oaWmx"
        "Y8cOgba2Njt37kRHR0egq6vLrl270NPTE+jr62NgYIChoaHAyMgIY2NjTExMBKampuzevRsz"
        "MzPMzc0Fe/bswcLCgr1792JpaYmVlRXW1tbY2NgI9u3bx/79+7G1teXAgQMcPHiQQ4cOcfjw"
        "YYGdnR1Hjhzh6NGj2Nvbc+zYMRwcHHB0dBQ4OTnh7OyMi4sLx48f58SJE7i6unLy5EmBm5sb"
        "p06d4vTp05w5c4azZ89y7tw5zp8/L3B3d+fChQt4eHjg6emJl5cX3t7e+Pj4CC5evIivry+X"
        "Ll3Cz88Pf39/AgICCAwMFAQFBREcHExISAihoaFcvnyZsLAwwsPDiYiIIDIyUhAVFcWVK1eI"
        "jo4mJiaG2NhYrl69yrVr14iLiyM+Pp6EhAQSExNJSkoiOTmZ69evc+PGDcHNmzdJSUkhNTWV"
        "W7ducfv2bdLS0khPTycjI4M7d+6QmZnJ3bt3ycrKIjs7m3v37pGTkyO4f/8+ubm5PHjwgIcP"
        "H5KXl8ejR494/Pgx+fn5FBQU8OTJE54+fcqzZ894/vw5L1684OXLl4JXr15RWFhIUVERr1+/"
        "5s2bNxQXF1NSUsLbt2959+4dpaWlvH//ng8fPlBWVkZ5eTkVFRWCyspKqqqqqK6upqamhtra"
        "Wurq6vj48SP19fU0NDTw6dMnGhsbaWpqorm5mZaWFlpbWwVtbW20t7fT0dFBZ2cnnz9/pqur"
        "i+7ubnp6eujt7aWvr4/+/n4GBgYYHBxkaGiIL1++CIaHh/n69SsjIyOMjo4yNjbGt2/fGB8f"
        "5/v370xMTPDjxw8mJyeZmpri58+fTE9PMzMzI5idneXXr1/8/v2bP3/+8PfvX+bm5pifn2dh"
        "YYHFxUWWlpb4byL/9v//i/wDHyiCUg=="
    )),
}
