"""Genuine MIRI FITS header layouts parsed end-to-end.

Two vendored header-dump fixtures (text, no pixel blobs):

* ``fixtures/miri_pce_cdp_header.txt`` — the VERBATIM card dump of a real
  MIRI instrument-team calibration product bundled with the reference
  checkout (`MIRI_FM_MIRIFUSHORT_1SHORT_PCE_07.00.00.fits`, CDP-7, author
  A. Glasse); a provenance test re-dumps the reference file and asserts
  the fixture matches card-for-card when the checkout is present.
* ``fixtures/miri_mrs_cal_header.txt`` — a stage-2 ``_cal.fits`` header in
  the JWST calwebb pipeline's layout: the keyword inventory, sectioning,
  CONTINUE long-string convention, and primary-vs-SCI split
  (CHANNEL/BAND/TARG_* in the primary; RA_V1/DEC_V1/PA_V3 + WCS in SCI)
  follow the public calwebb_spec2 product format keyword-for-keyword.
  Values are representative of the PDRs4All ERS program 1288 Orion Bar
  MRS observation (the reference's production target) — this environment
  has no network access to pull a MAST file, so the layout, not the pixel
  values, is what this fixture pins.  Note the genuine quirks it carries:
  CHANNEL='12' (one MRS detector covers two channels, so band selection
  NEEDS the caller's chan_name, as in the reference's correction flow),
  and S_REGION spanning a CONTINUE card.

The tests rebuild real FITS bytes from the dumps (cards re-padded to 80
columns, zero data payloads of the declared shapes) and drive them through
``fits_io`` → ``realmiri.get_IFU`` → ``preprocessing.metadata``.
"""

import os

import numpy as np
import pytest

from surfh_tpu.instrument.realmiri import get_IFU
from surfh_tpu.preprocessing import metadata
from surfh_tpu.preprocessing.fits_io import fits_open

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
REF_PCE = (
    "/root/reference/surfh/data/MIRI_FM_MIRIFUSHORT_1SHORT_PCE_07.00.00.fits"
)


def rebuild_fits(dump_path: str) -> bytes:
    """Reconstruct FITS bytes from a header card dump.

    Sections are separated by ``[HDU n]`` lines; each card is re-padded to
    80 columns; each HDU's data payload is written as zeros of the size its
    header declares (BITPIX/NAXISn/PCOUNT/GCOUNT)."""
    text = open(dump_path).read()
    sections = [s for s in _split_sections(text)]
    out = bytearray()
    for cards in sections:
        hdr = {}
        for c in cards:
            if "=" in c[8:10] or c[8:10] == "= ":
                key = c[:8].strip()
                val = c[10:].split("/")[0].strip()
                hdr[key] = val
        block = b"".join(c.encode("ascii").ljust(80) for c in cards)
        pad = (-len(block)) % 2880
        out += block + b" " * pad
        naxis = int(hdr.get("NAXIS", "0"))
        if naxis:
            n = 1
            for i in range(1, naxis + 1):
                n *= int(hdr[f"NAXIS{i}"])
            nbytes = n * abs(int(hdr["BITPIX"])) // 8
            nbytes *= int(hdr.get("GCOUNT", "1"))
            nbytes += int(hdr.get("PCOUNT", "0"))
            out += b"\x00" * (nbytes + ((-nbytes) % 2880))
    return bytes(out)


def _split_sections(text):
    cards = []
    for line in text.splitlines():
        if line.startswith("[HDU"):
            if cards:
                yield cards
            cards = []
        else:
            cards.append(line[:80])
    if cards:
        yield cards


@pytest.fixture(scope="module")
def cal_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("hdr") / "jw01288_mirifushort_cal.fits"
    p.write_bytes(rebuild_fits(os.path.join(FIXDIR, "miri_mrs_cal_header.txt")))
    return str(p)


@pytest.fixture(scope="module")
def pce_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("hdr") / "miri_pce_cdp.fits"
    p.write_bytes(rebuild_fits(os.path.join(FIXDIR, "miri_pce_cdp_header.txt")))
    return str(p)


def test_cal_header_layout_parses(cal_path):
    hdus = fits_open(cal_path)
    hdr0, hdr1 = hdus[0].header, hdus[1].header
    # genuine primary-header quirks
    assert hdr0["CHANNEL"] == "12"  # one detector, two channels
    assert hdr0["BAND"] == "SHORT"
    assert hdr0["DETECTOR"] == "MIRIFUSHORT"
    assert hdr0["EXP_TYPE"] == "MIR_MRS"
    assert hdr0["TARG_RA"] == pytest.approx(83.8354047)
    assert hdr0["TARG_DEC"] == pytest.approx(-5.4170556)
    assert hdr0["PROGRAM"].strip() == "01288"
    # pointing lives in the SCI extension, not the primary
    assert "PA_V3" not in hdr0
    assert hdr1["RA_V1"] == pytest.approx(83.84119342)
    assert hdr1["DEC_V1"] == pytest.approx(-5.41190354)
    assert hdr1["PA_V3"] == pytest.approx(68.5755435)
    # CONTINUE long-string convention is reassembled
    assert hdr1["S_REGION"].startswith("POLYGON ICRS")
    assert hdr1["S_REGION"].rstrip().endswith("-5.414802731")
    assert "&" not in hdr1["S_REGION"]


def test_get_ifu_from_real_cal_layout(cal_path):
    # the reference flow always passes the band name for MRS cal files
    # (correction_mrs_data.py passes '1a'-style names) — CHANNEL='12' is
    # ambiguous by itself
    ifu, ra, dec = get_IFU(cal_path, chan_name="1a")
    assert ifu.name == "1A"
    assert ifu.n_slit == 21
    assert ifu.det_pix_size == pytest.approx(0.196)
    # pointing comes from the SCI extension's V1 axis + V3 position angle
    assert ra == pytest.approx(83.84119342)
    assert dec == pytest.approx(-5.41190354)
    assert ifu.fov.angle == pytest.approx(8.2 + 68.5755435, abs=0.5)
    assert ifu.wavel_axis.size == 1050  # band 1A detector grid

    ifu4, _, _ = get_IFU(cal_path, chan_name="4c")
    assert ifu4.name == "4C"
    assert ifu4.n_slit == 12


def test_get_ifu_rejects_ambiguous_channel(cal_path):
    with pytest.raises(ValueError, match="two MRS channels"):
        get_IFU(cal_path)


def test_metadata_pointing_on_real_layout(cal_path):
    hdr = metadata._pointing_header(cal_path)
    # RA_V1 is in HDU 1 on genuine products; _pointing_header must find it
    assert hdr["RA_V1"] == pytest.approx(83.84119342)
    assert hdr["PA_V3"] == pytest.approx(68.5755435)


def test_pce_cdp_header_parses(pce_path):
    hdus = fits_open(pce_path)
    hdr0 = hdus[0].header
    assert hdr0["DETECTOR"] == "MIRIFUSHORT"
    assert hdr0["CHANNEL"] == "1"
    assert hdr0["BAND"] == "SHORT"
    assert hdr0["REFTYPE"] == "PCE"
    tbl = hdus[1]
    assert tbl.header["XTENSION"].strip() == "BINTABLE"
    assert tbl.columns is not None
    assert set(tbl.columns) == {"WAVELENGTH", "EFFICIENCY", "CONVERSION"}
    assert tbl.columns["WAVELENGTH"].shape == (201,)


@pytest.mark.skipif(not os.path.exists(REF_PCE), reason="reference absent")
def test_pce_dump_matches_reference_file():
    """Provenance: the vendored dump IS the real file's header, card for
    card (trailing blanks stripped)."""
    buf = open(REF_PCE, "rb").read()
    fixture = open(os.path.join(FIXDIR, "miri_pce_cdp_header.txt")).read()
    fix_cards = [
        c for sec in _split_sections(fixture) for c in sec
    ]
    real_cards = []
    off = 0
    for _ in range(2):
        while True:
            block = buf[off : off + 2880]
            off += 2880
            stop = False
            for i in range(0, 2880, 80):
                card = block[i : i + 80].decode("ascii").rstrip()
                real_cards.append(card)
                if card.startswith("END"):
                    stop = True
                    break
            if stop:
                break
        # skip this HDU's data payload
        hdr = {
            c[:8].strip(): c[10:].split("/")[0].strip()
            for c in real_cards
            if c[8:10] == "= "
        }
        naxis = int(hdr.get("NAXIS", "0"))
        if naxis:
            n = 1
            for i in range(1, naxis + 1):
                n *= int(hdr[f"NAXIS{i}"])
            nbytes = n * abs(int(hdr["BITPIX"])) // 8
            off += nbytes + ((-nbytes) % 2880)
    assert [c.rstrip() for c in fix_cards] == real_cards
