// JPEG 2000 tile decoding as openjpeg 2.5.4 decodes a tile for Pillow 12.1
// (opj_decode_tile_data): tier 2 (the packet iterator in the five
// progression orders and POC changes, tag trees, packet headers with bit
// stuffing, SOP/EPH, packed headers from PPM/PPT), tier 1 (the MQ decoder,
// its 19 contexts, the three passes, the code-block styles BYPASS, RESET,
// TERMALL, VSC, PTERM and SEGSYM, the ROI max-shift), dequantisation, the
// inverse 5/3 and 9/7 wavelets (openjpeg's lifting steps, float32 in its
// order of operations), the inverse RCT and ICT and the DC level shift.
//
// The markers, the container and Pillow's unpacking are Python
// (serve/jpeg2000.py); this file decodes one tile from its parameters, its
// data (the tile-parts' bodies concatenated) and, where the headers are
// packed, the PPM or PPT bytes. The arithmetic follows openjpeg's types:
// unsigned 32-bit geometry with its wrap-around, int32 samples, float32
// for the irreversible path without contraction of multiply-adds (the
// library is built with -ffp-contract=off).
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_set>
#include <vector>

namespace {

typedef uint32_t u32;
typedef int32_t i32;
typedef int64_t i64;
typedef uint64_t u64;

enum {
    OK = 0,
    E_PARAMS = -1,
    E_SEGMENT = -2,      // a code-block segment runs past the tile's data
    E_BITNUMBER = -3,    // a length field of more than 32 bits
    E_BPNO = -4,         // 31 or more bit-planes in a code-block
    E_MCT = -5,          // components of different sizes under the MCT
    E_INCLUDE = -6,      // the packet iterator's table cannot be sized
    E_PROGRESSION = -7,  // an unknown progression order
    E_OVERFLOW = -8,     // precinct or tile geometry beyond 31 bits
    E_LIMIT = -9,        // more precincts or code-blocks than the port holds
    E_PRECINCT = -10,    // a precinct index beyond the band's
    E_EPH = -11,         // a packet header without its EPH marker
};

// geometry helpers, as opj_intmath.h
inline i32 int_ceildiv(i32 a, i32 b) {
    return (i32)(((i64)a + b - 1) / b);
}
inline i32 int_ceildivpow2(i32 a, i32 b) {
    return (i32)((a + ((i64)1 << b) - 1) >> b);
}
inline i32 int64_ceildivpow2(i64 a, i32 b) {
    return (i32)((a + ((i64)1 << b) - 1) >> b);
}
inline i32 int_floordivpow2(i32 a, i32 b) { return a >> b; }
inline u32 uint_ceildivpow2(u32 a, u32 b) {
    return (u32)((a + ((u64)1U << b) - 1U) >> b);
}
inline u32 uint_floordivpow2(u32 a, u32 b) { return a >> b; }
inline u32 uint_ceildiv(u32 a, u32 b) {
    return (u32)(((u64)a + b - 1) / b);
}
inline u32 uint64_ceildiv_res_uint32(u64 a, u64 b) {
    return (u32)((a + b - 1) / b);
}
inline u32 umin(u32 a, u32 b) { return a < b ? a : b; }
inline u32 umax(u32 a, u32 b) { return a > b ? a : b; }
inline i32 imin(i32 a, i32 b) { return a < b ? a : b; }
inline i32 imax(i32 a, i32 b) { return a > b ? a : b; }
inline u32 floorlog2(u32 a) {
    u32 l = 0;
    while (a > 1) {
        a >>= 1;
        ++l;
    }
    return l;
}
inline i32 wrap_add(i32 a, i32 b) { return (i32)((u32)a + (u32)b); }

// ------------------------------------------------------------ parameters

const int MAXRLVLS = 33;
const int MAXBANDS = 97;

struct Poc {
    u32 resno0, compno0, layno1, resno1, compno1;
    int prg;  // 0..4, else no packets (an unknown order: -1)
};

struct CompParams {
    u32 dx, dy, prec, sgnd;
    u32 numres, cblkw, cblkh, cblksty, qmfbid, qntsty, numgbits, roishift;
    i32 dc_shift;  // from SIZ: a CBD segment changes prec and sgnd only
    u32 prcw[MAXRLVLS], prch[MAXRLVLS];
    i32 expn[MAXBANDS];
    i32 mant[MAXBANDS];
};

struct TileParams {
    i32 x0, y0, x1, y1;  // the tile on the reference grid
    u32 numcomps;
    int prg;             // -1: unknown
    u32 numlayers, mct, csty;
    bool poc;
    std::vector<Poc> pocs;  // numpocs + 1 of them where poc
    std::vector<CompParams> comps;
};

// ------------------------------------------------------------ tag trees

struct TagTree {
    struct Node {
        i32 parent;
        i32 value, low;
    };
    std::vector<Node> nodes;

    void init(u32 w, u32 h) {
        nodes.clear();
        if (w == 0 || h == 0) return;
        std::vector<u32> lw, lh;
        lw.push_back(w);
        lh.push_back(h);
        u64 total = 0;
        for (;;) {
            u64 n = (u64)lw.back() * lh.back();
            total += n;
            if (n <= 1) break;
            lw.push_back((lw.back() + 1) / 2);
            lh.push_back((lh.back() + 1) / 2);
        }
        nodes.resize(total);
        u64 base = 0;
        for (size_t l = 0; l < lw.size(); ++l) {
            u64 next = base + (u64)lw[l] * lh[l];
            for (u32 j = 0; j < lh[l]; ++j)
                for (u32 i = 0; i < lw[l]; ++i) {
                    Node& nd = nodes[base + (u64)j * lw[l] + i];
                    if (l + 1 < lw.size())
                        nd.parent = (i32)(next + (u64)(j / 2) * lw[l + 1] +
                                          i / 2);
                    else
                        nd.parent = -1;
                }
            base = next;
        }
        reset();
    }
    void reset() {
        for (auto& n : nodes) {
            n.value = 999;
            n.low = 0;
        }
    }
};

// ------------------------------------------------------------ bit reader

struct Bio {  // opj_bio_t for decoding
    const uint8_t *start, *end, *bp;
    u32 buf, ct;
    void init(const uint8_t* p, u32 len) {
        start = bp = p;
        end = p + len;
        buf = 0;
        ct = 0;
    }
    void bytein() {
        buf = (buf << 8) & 0xffff;
        ct = buf == 0xff00 ? 7 : 8;
        if (bp >= end) return;
        buf |= *bp++;
    }
    u32 getbit() {
        if (ct == 0) bytein();
        ct--;
        return (buf >> ct) & 1;
    }
    u32 read(u32 n) {
        u32 v = 0;
        for (u32 i = n - 1; i < n; i--) v |= getbit() << i;
        return v;
    }
    void inalign() {
        if ((buf & 0xff) == 0xff) bytein();
        ct = 0;
    }
    u32 numbytes() const { return (u32)(bp - start); }
};

u32 tgt_decode(Bio& bio, TagTree& tree, u32 leafno, i32 threshold) {
    i32 stk[64];
    int sp = 0;
    i32 node = (i32)leafno;
    while (tree.nodes[node].parent >= 0) {
        stk[sp++] = node;
        node = tree.nodes[node].parent;
    }
    i32 low = 0;
    for (;;) {
        TagTree::Node& n = tree.nodes[node];
        if (low > n.low)
            n.low = low;
        else
            low = n.low;
        while (low < threshold && low < n.value) {
            if (bio.read(1))
                n.value = low;
            else
                ++low;
        }
        n.low = low;
        if (sp == 0) break;
        node = stk[--sp];
    }
    return tree.nodes[node].value < threshold ? 1 : 0;
}

// ------------------------------------------------------------ tile model

struct Seg {
    u32 len, numpasses, real_num_passes, maxpasses, numnewpasses, newlen;
};
struct Chunk {
    const uint8_t* data;
    u32 len;
};
struct Cblk {
    i32 x0, y0, x1, y1;
    u32 numbps, numlenbits, numnewpasses, numsegs, real_num_segs;
    std::vector<Seg> segs;
    std::vector<Chunk> chunks;
};
struct Prec {
    i32 x0, y0, x1, y1;
    u32 cw, ch;
    std::vector<Cblk> cblks;
    TagTree incl, imsb;
};
struct Band {
    u32 bandno;
    i32 x0, y0, x1, y1;
    float stepsize;
    i32 numbps;
    std::vector<Prec> precs;
    bool empty() const { return x1 - x0 == 0 || y1 - y0 == 0; }
};
struct Res {
    i32 x0, y0, x1, y1;
    u32 pw, ph, pdx, pdy, numbands;
    Band bands[3];
};
struct TileComp {
    i32 x0, y0, x1, y1;
    u32 numres;
    std::vector<Res> res;
    std::vector<i32> data;  // float bits for the irreversible path
    u32 resno_decoded;
    // the full resolution's width and height: the data's stride and rows
    size_t w() const { return (size_t)(res[numres - 1].x1 - res[numres - 1].x0); }
    size_t h() const { return (size_t)(res[numres - 1].y1 - res[numres - 1].y0); }
};

const u64 MAX_BLOCKS = (u64)1 << 26;  // precincts and code-blocks in a tile

int init_tile(const TileParams& tp, std::vector<TileComp>& comps) {
    comps.resize(tp.numcomps);
    u64 blocks = 0;
    for (u32 c = 0; c < tp.numcomps; ++c) {
        const CompParams& cp = tp.comps[c];
        TileComp& tc = comps[c];
        tc.resno_decoded = 0;
        tc.x0 = int_ceildiv(tp.x0, (i32)cp.dx);
        tc.y0 = int_ceildiv(tp.y0, (i32)cp.dy);
        tc.x1 = int_ceildiv(tp.x1, (i32)cp.dx);
        tc.y1 = int_ceildiv(tp.y1, (i32)cp.dy);
        tc.numres = cp.numres;
        tc.res.resize(cp.numres);
        u32 level = cp.numres;
        int step = 0;
        for (u32 r = 0; r < cp.numres; ++r) {
            Res& res = tc.res[r];
            --level;
            res.x0 = int_ceildivpow2(tc.x0, (i32)level);
            res.y0 = int_ceildivpow2(tc.y0, (i32)level);
            res.x1 = int_ceildivpow2(tc.x1, (i32)level);
            res.y1 = int_ceildivpow2(tc.y1, (i32)level);
            u32 pdx = cp.prcw[r], pdy = cp.prch[r];
            res.pdx = pdx;
            res.pdy = pdy;
            i32 tlx = int_floordivpow2(res.x0, (i32)pdx) << pdx;
            i32 tly = int_floordivpow2(res.y0, (i32)pdy) << pdy;
            u32 tmp = ((u32)int_ceildivpow2(res.x1, (i32)pdx)) << pdx;
            if (tmp > (u32)INT32_MAX) return E_OVERFLOW;
            i32 brx = (i32)tmp;
            tmp = ((u32)int_ceildivpow2(res.y1, (i32)pdy)) << pdy;
            if (tmp > (u32)INT32_MAX) return E_OVERFLOW;
            i32 bry = (i32)tmp;
            res.pw = res.x0 == res.x1 ? 0U : (u32)((brx - tlx) >> pdx);
            res.ph = res.y0 == res.y1 ? 0U : (u32)((bry - tly) >> pdy);
            if (res.pw != 0U && (0xFFFFFFFFU / res.pw) < res.ph)
                return E_OVERFLOW;
            u32 nprec = res.pw * res.ph;
            i32 cbgx0, cbgy0;
            u32 cbgwexp, cbghexp;
            if (r == 0) {
                cbgx0 = tlx;
                cbgy0 = tly;
                cbgwexp = pdx;
                cbghexp = pdy;
                res.numbands = 1;
            } else {
                cbgx0 = int_ceildivpow2(tlx, 1);
                cbgy0 = int_ceildivpow2(tly, 1);
                cbgwexp = pdx - 1;
                cbghexp = pdy - 1;
                res.numbands = 3;
            }
            u32 cbw = umin(cp.cblkw, cbgwexp), cbh = umin(cp.cblkh, cbghexp);
            for (u32 b = 0; b < res.numbands; ++b, ++step) {
                Band& band = res.bands[b];
                if (r == 0) {
                    band.bandno = 0;
                    band.x0 = int_ceildivpow2(tc.x0, (i32)level);
                    band.y0 = int_ceildivpow2(tc.y0, (i32)level);
                    band.x1 = int_ceildivpow2(tc.x1, (i32)level);
                    band.y1 = int_ceildivpow2(tc.y1, (i32)level);
                } else {
                    band.bandno = b + 1;
                    i64 x0b = band.bandno & 1, y0b = band.bandno >> 1;
                    band.x0 = int64_ceildivpow2(tc.x0 - (x0b << level),
                                                (i32)(level + 1));
                    band.y0 = int64_ceildivpow2(tc.y0 - (y0b << level),
                                                (i32)(level + 1));
                    band.x1 = int64_ceildivpow2(tc.x1 - (x0b << level),
                                                (i32)(level + 1));
                    band.y1 = int64_ceildivpow2(tc.y1 - (y0b << level),
                                                (i32)(level + 1));
                }
                i32 log2_gain = cp.qmfbid == 0 ? 0
                                : band.bandno == 0 ? 0
                                : band.bandno == 3 ? 2
                                                   : 1;
                i32 rb = (i32)cp.prec + log2_gain;
                band.stepsize = (float)((1.0 + cp.mant[step] / 2048.0) *
                                        std::pow(2.0, (i32)(rb - cp.expn[step])));
                band.numbps = cp.expn[step] + (i32)cp.numgbits - 1;
                blocks += nprec;
                if (blocks > MAX_BLOCKS) return E_LIMIT;
                band.precs.assign(nprec, Prec());
                for (u32 p = 0; p < nprec; ++p) {
                    Prec& pr = band.precs[p];
                    i32 cx0 = cbgx0 + (i32)(p % res.pw) * (1 << cbgwexp);
                    i32 cy0 = cbgy0 + (i32)(p / res.pw) * (1 << cbghexp);
                    i32 cx1 = cx0 + (1 << cbgwexp), cy1 = cy0 + (1 << cbghexp);
                    pr.x0 = imax(cx0, band.x0);
                    pr.y0 = imax(cy0, band.y0);
                    pr.x1 = imin(cx1, band.x1);
                    pr.y1 = imin(cy1, band.y1);
                    i32 tbx = int_floordivpow2(pr.x0, (i32)cbw) << cbw;
                    i32 tby = int_floordivpow2(pr.y0, (i32)cbh) << cbh;
                    i32 bbx = int_ceildivpow2(pr.x1, (i32)cbw) << cbw;
                    i32 bby = int_ceildivpow2(pr.y1, (i32)cbh) << cbh;
                    pr.cw = (u32)((bbx - tbx) >> cbw);
                    pr.ch = (u32)((bby - tby) >> cbh);
                    u64 nb = (u64)pr.cw * pr.ch;
                    blocks += nb;
                    if (blocks > MAX_BLOCKS) return E_LIMIT;
                    pr.cblks.assign(nb, Cblk());
                    for (u64 k = 0; k < nb; ++k) {
                        Cblk& cb = pr.cblks[k];
                        i32 bx0 = tbx + (i32)(k % pr.cw) * (1 << cbw);
                        i32 by0 = tby + (i32)(k / pr.cw) * (1 << cbh);
                        cb.x0 = imax(bx0, pr.x0);
                        cb.y0 = imax(by0, pr.y0);
                        cb.x1 = imin(bx0 + (1 << cbw), pr.x1);
                        cb.y1 = imin(by0 + (1 << cbh), pr.y1);
                        cb.numbps = cb.numlenbits = cb.numnewpasses = 0;
                        cb.numsegs = cb.real_num_segs = 0;
                    }
                    pr.incl.init(pr.cw, pr.ch);
                    pr.imsb.init(pr.cw, pr.ch);
                }
            }
        }
    }
    return OK;
}

// ------------------------------------------------------------ tier 2

struct PacketIterator {
    // opj_pi_iterator_t for decoding, one for each POC (or one)
    u32 compno, resno, precno, layno;
    u32 x, y, dx, dy;
    bool first;
    Poc poc;
    u32 precno0, precno1, layno0;
    i32 ptx0, pty0, ptx1, pty1;
};

struct PiShared {
    u32 tx0, ty0, tx1, ty1;
    u32 step_l, step_r, step_c, step_p;
    u64 include_size;
    std::unordered_set<u32> included;  // openjpeg's include table, as a set

    bool take(u32 index) {  // the packet is new: mark it
        return included.insert(index).second;
    }
    struct CompRes {
        u32 pdx, pdy, pw, ph;
    };
    std::vector<std::vector<CompRes>> res;  // [comp][res]
    std::vector<u32> cdx, cdy, cnumres;
};

// opj_pi_create_decode with opj_get_all_encoding_parameters: the tile's
// box (already clipped to the image), each resolution's precinct grid,
// the include table's steps
int pi_create(const TileParams& tp, PiShared& sh, u32& max_res,
              u32& max_prec) {
    sh.tx0 = (u32)tp.x0;
    sh.ty0 = (u32)tp.y0;
    sh.tx1 = (u32)tp.x1;
    sh.ty1 = (u32)tp.y1;
    max_prec = 0;
    max_res = 0;
    u32 n = tp.numcomps;
    sh.res.assign(n, {});
    sh.cdx.resize(n);
    sh.cdy.resize(n);
    sh.cnumres.resize(n);
    for (u32 c = 0; c < n; ++c) {
        const CompParams& cp = tp.comps[c];
        sh.cdx[c] = cp.dx;
        sh.cdy[c] = cp.dy;
        sh.cnumres[c] = cp.numres;
        u32 tcx0 = uint_ceildiv(sh.tx0, cp.dx), tcy0 = uint_ceildiv(sh.ty0, cp.dy);
        u32 tcx1 = uint_ceildiv(sh.tx1, cp.dx), tcy1 = uint_ceildiv(sh.ty1, cp.dy);
        if (cp.numres > max_res) max_res = cp.numres;
        u32 level = cp.numres;
        sh.res[c].resize(cp.numres);
        for (u32 r = 0; r < cp.numres; ++r) {
            --level;
            u32 pdx = cp.prcw[r], pdy = cp.prch[r];
            u32 rx0 = uint_ceildivpow2(tcx0, level), ry0 = uint_ceildivpow2(tcy0, level);
            u32 rx1 = uint_ceildivpow2(tcx1, level), ry1 = uint_ceildivpow2(tcy1, level);
            u32 px0 = uint_floordivpow2(rx0, pdx) << pdx;
            u32 py0 = uint_floordivpow2(ry0, pdy) << pdy;
            u32 px1 = uint_ceildivpow2(rx1, pdx) << pdx;
            u32 py1 = uint_ceildivpow2(ry1, pdy) << pdy;
            u32 pw = rx0 == rx1 ? 0 : ((px1 - px0) >> pdx);
            u32 ph = ry0 == ry1 ? 0 : ((py1 - py0) >> pdy);
            sh.res[c][r] = {pdx, pdy, pw, ph};
            u32 product = pw * ph;
            if (product > max_prec) max_prec = product;
        }
    }
    sh.step_p = 1;
    sh.step_c = max_prec * sh.step_p;
    sh.step_r = n * sh.step_c;
    sh.step_l = max_res * sh.step_r;
    if (!(sh.step_l <= 0xFFFFFFFFU / (tp.numlayers + 1U))) return E_INCLUDE;
    sh.include_size = (u64)(tp.numlayers + 1U) * sh.step_l;
    return OK;
}

// The body shared by RPCL, PCRL and CPRL: whether (x, y) starts a
// precinct of (compno, resno); sets precno.
bool position_precinct(PiShared& sh, PacketIterator& pi) {
    u32 c = pi.compno;
    const PiShared::CompRes& res = sh.res[c][pi.resno];
    u32 numres = sh.cnumres[c];
    u32 cdx = sh.cdx[c], cdy = sh.cdy[c];
    u32 levelno = numres - 1 - pi.resno;
    if ((u32)(((u64)cdx << levelno) >> levelno) != cdx ||
        (u32)(((u64)cdy << levelno) >> levelno) != cdy)
        return false;
    u32 trx0 = uint64_ceildiv_res_uint32((u64)sh.tx0, (u64)cdx << levelno);
    u32 try0 = uint64_ceildiv_res_uint32((u64)sh.ty0, (u64)cdy << levelno);
    u32 trx1 = uint64_ceildiv_res_uint32((u64)sh.tx1, (u64)cdx << levelno);
    u32 try1 = uint64_ceildiv_res_uint32((u64)sh.ty1, (u64)cdy << levelno);
    u32 rpx = res.pdx + levelno, rpy = res.pdy + levelno;
    if (!(((u64)pi.y % ((u64)cdy << rpy) == 0) ||
          ((pi.y == sh.ty0) && (((u64)try0 << levelno) % ((u64)1U << rpy)))))
        return false;
    if (!(((u64)pi.x % ((u64)cdx << rpx) == 0) ||
          ((pi.x == sh.tx0) && (((u64)trx0 << levelno) % ((u64)1U << rpx)))))
        return false;
    if (res.pw == 0 || res.ph == 0) return false;
    if (trx0 == trx1 || try0 == try1) return false;
    u32 prci = uint_floordivpow2(uint64_ceildiv_res_uint32(
                                     (u64)pi.x, (u64)cdx << levelno),
                                 res.pdx) -
               uint_floordivpow2(trx0, res.pdx);
    u32 prcj = uint_floordivpow2(uint64_ceildiv_res_uint32(
                                     (u64)pi.y, (u64)cdy << levelno),
                                 res.pdy) -
               uint_floordivpow2(try0, res.pdy);
    pi.precno = prci + prcj * res.pw;
    return true;
}

void min_steps(PiShared& sh, u32 c, u32& dx, u32& dy) {
    u32 numres = sh.cnumres[c];
    for (u32 r = 0; r < numres; ++r) {
        const PiShared::CompRes& res = sh.res[c][r];
        u32 sx = res.pdx + numres - 1 - r, sy = res.pdy + numres - 1 - r;
        if (sx < 32 && sh.cdx[c] <= 0xFFFFFFFFU / (1u << sx)) {
            u32 v = sh.cdx[c] * (1u << sx);
            dx = !dx ? v : umin(dx, v);
        }
        if (sy < 32 && sh.cdy[c] <= 0xFFFFFFFFU / (1u << sy)) {
            u32 v = sh.cdy[c] * (1u << sy);
            dy = !dy ? v : umin(dy, v);
        }
    }
}

// The packet iterator as a resumable loop nest. Each order is written as
// a generator: `next` returns true with (layno, resno, compno, precno) set
// for each packet not seen before, false at the end (or where openjpeg's
// iterator gives up).
struct Iter {
    PiShared* sh;
    PacketIterator pi;
    u32 numcomps;
    int state;  // 0: not started, 1: running, 2: done
    // loop registers
    u32 l, r, c, p, yy, xx;
    u32 lim_r;
};

inline u32 packet_index(PiShared& sh, u32 l, u32 r, u32 c, u32 p) {
    return l * sh.step_l + r * sh.step_r + c * sh.step_c + p * sh.step_p;
}

// returns 1 packet, 0 end
int iter_next(Iter& it) {
    PiShared& sh = *it.sh;
    PacketIterator& pi = it.pi;
    Poc& poc = pi.poc;
    if (it.state == 2) return 0;
    if (poc.compno0 >= it.numcomps || poc.compno1 >= it.numcomps + 1) {
        it.state = 2;
        return 0;
    }
    switch (poc.prg) {
    case 0:    // LRCP
    case 1: {  // RLCP
        bool lrcp = poc.prg == 0;
        u32 &outer = lrcp ? it.l : it.r, &inner = lrcp ? it.r : it.l;
        u32 o0 = lrcp ? pi.layno0 : poc.resno0, o1 = lrcp ? poc.layno1 : poc.resno1;
        u32 i0 = lrcp ? poc.resno0 : pi.layno0, i1 = lrcp ? poc.resno1 : poc.layno1;
        if (it.state == 0) {
            it.state = 1;
            outer = o0;
            goto lr_outer;
        }
        goto lr_resume;
    lr_outer:
        for (; outer < o1; ++outer) {
            for (inner = i0; inner < i1; ++inner) {
                for (it.c = poc.compno0; it.c < poc.compno1; ++it.c) {
                    if (it.r >= sh.cnumres[it.c]) continue;
                    {
                        const PiShared::CompRes& res = sh.res[it.c][it.r];
                        pi.precno1 = res.pw * res.ph;
                    }
                    for (it.p = pi.precno0; it.p < pi.precno1; ++it.p) {
                        {
                            u32 index = packet_index(sh, it.l, it.r, it.c, it.p);
                            if (index >= sh.include_size) {
                                it.state = 2;
                                return 0;
                            }
                            if (sh.take(index)) {
                                pi.layno = it.l;
                                pi.resno = it.r;
                                pi.compno = it.c;
                                pi.precno = it.p;
                                return 1;
                            }
                        }
                    lr_resume:;
                    }
                }
            }
        }
        it.state = 2;
        return 0;
    }
    case 2:    // RPCL
    case 3: {  // PCRL
        if (it.state == 0) {
            it.state = 1;
            pi.dx = pi.dy = 0;
            for (u32 c = 0; c < it.numcomps; ++c) min_steps(sh, c, pi.dx, pi.dy);
            if (pi.dx == 0 || pi.dy == 0) {
                it.state = 2;
                return 0;
            }
            if (poc.prg == 2) goto rpcl_start;
            goto pcrl_start;
        }
        if (poc.prg == 2) goto rpcl_resume;
        goto pcrl_resume;
    rpcl_start:
        for (it.r = poc.resno0; it.r < poc.resno1; ++it.r) {
            for (it.yy = sh.ty0; it.yy < sh.ty1; it.yy += (pi.dy - (it.yy % pi.dy))) {
                for (it.xx = sh.tx0; it.xx < sh.tx1;
                     it.xx += (pi.dx - (it.xx % pi.dx))) {
                    for (it.c = poc.compno0; it.c < poc.compno1; ++it.c) {
                        if (it.r >= sh.cnumres[it.c]) continue;
                        pi.compno = it.c;
                        pi.resno = it.r;
                        pi.x = it.xx;
                        pi.y = it.yy;
                        if (!position_precinct(sh, pi)) continue;
                        for (it.l = pi.layno0; it.l < poc.layno1; ++it.l) {
                            {
                                u32 index = packet_index(sh, it.l, it.r, it.c, pi.precno);
                                if (index >= sh.include_size) {
                                    it.state = 2;
                                    return 0;
                                }
                                if (sh.take(index)) {
                                    pi.layno = it.l;
                                    return 1;
                                }
                            }
                        rpcl_resume:;
                        }
                    }
                }
            }
        }
        it.state = 2;
        return 0;
    pcrl_start:
        for (it.yy = sh.ty0; it.yy < sh.ty1; it.yy += (pi.dy - (it.yy % pi.dy))) {
            for (it.xx = sh.tx0; it.xx < sh.tx1; it.xx += (pi.dx - (it.xx % pi.dx))) {
                for (it.c = poc.compno0; it.c < poc.compno1; ++it.c) {
                    it.lim_r = umin(poc.resno1, sh.cnumres[it.c]);
                    for (it.r = poc.resno0; it.r < it.lim_r; ++it.r) {
                        pi.compno = it.c;
                        pi.resno = it.r;
                        pi.x = it.xx;
                        pi.y = it.yy;
                        if (!position_precinct(sh, pi)) continue;
                        for (it.l = pi.layno0; it.l < poc.layno1; ++it.l) {
                            {
                                u32 index = packet_index(sh, it.l, it.r, it.c, pi.precno);
                                if (index >= sh.include_size) {
                                    it.state = 2;
                                    return 0;
                                }
                                if (sh.take(index)) {
                                    pi.layno = it.l;
                                    return 1;
                                }
                            }
                        pcrl_resume:;
                        }
                    }
                }
            }
        }
        it.state = 2;
        return 0;
    }
    case 4: {  // CPRL
        if (it.state == 0) {
            it.state = 1;
            goto cprl_start;
        }
        goto cprl_resume;
    cprl_start:
        for (it.c = poc.compno0; it.c < poc.compno1; ++it.c) {
            pi.dx = pi.dy = 0;
            min_steps(sh, it.c, pi.dx, pi.dy);
            if (pi.dx == 0 || pi.dy == 0) {
                it.state = 2;
                return 0;
            }
            for (it.yy = sh.ty0; it.yy < sh.ty1; it.yy += (pi.dy - (it.yy % pi.dy))) {
                for (it.xx = sh.tx0; it.xx < sh.tx1;
                     it.xx += (pi.dx - (it.xx % pi.dx))) {
                    it.lim_r = umin(poc.resno1, sh.cnumres[it.c]);
                    for (it.r = poc.resno0; it.r < it.lim_r; ++it.r) {
                        pi.compno = it.c;
                        pi.resno = it.r;
                        pi.x = it.xx;
                        pi.y = it.yy;
                        if (!position_precinct(sh, pi)) continue;
                        for (it.l = pi.layno0; it.l < poc.layno1; ++it.l) {
                            {
                                u32 index = packet_index(sh, it.l, it.r, it.c, pi.precno);
                                if (index >= sh.include_size) {
                                    it.state = 2;
                                    return 0;
                                }
                                if (sh.take(index)) {
                                    pi.layno = it.l;
                                    return 1;
                                }
                            }
                        cprl_resume:;
                        }
                    }
                }
            }
        }
        it.state = 2;
        return 0;
    }
    default:
        it.state = 2;
        return 0;
    }
}

void init_seg(Cblk& cb, u32 index, u32 cblksty, bool first) {
    if (cb.segs.size() < index + 1) cb.segs.resize(index + 1);
    Seg& s = cb.segs[index];
    std::memset(&s, 0, sizeof(Seg));
    if (cblksty & 0x04) {  // TERMALL
        s.maxpasses = 1;
    } else if (cblksty & 0x01) {  // BYPASS
        if (first) {
            s.maxpasses = 10;
        } else {
            u32 prev = cb.segs[index - 1].maxpasses;
            s.maxpasses = (prev == 1 || prev == 10) ? 2 : 1;
        }
    } else {
        s.maxpasses = 109;
    }
}

u32 getnumpasses(Bio& bio) {
    u32 n;
    if (!bio.read(1)) return 1;
    if (!bio.read(1)) return 2;
    if ((n = bio.read(2)) != 3) return 3 + n;
    if ((n = bio.read(5)) != 31) return 6 + n;
    return 37 + bio.read(7);
}

u32 getcommacode(Bio& bio) {
    u32 n = 0;
    while (bio.read(1)) ++n;
    return n;
}

struct Headers {  // where packet headers come from (PPM/PPT), else null
    const uint8_t* data;
    u32 len;
    bool packed;
};

// opj_t2_read_packet_header + read/skip_packet_data
int decode_packet(const TileParams& tp, std::vector<TileComp>& comps,
                  const PacketIterator& pi, const uint8_t* src, u32 max_len,
                  Headers& hdr, bool skip, u32& read) {
    TileComp& tc = comps[pi.compno];
    Res& res = tc.res[pi.resno];
    const CompParams& cp = tp.comps[pi.compno];
    const uint8_t* cur = src;
    if (pi.layno == 0) {
        for (u32 b = 0; b < res.numbands; ++b) {
            Band& band = res.bands[b];
            if (band.empty()) continue;
            if (!(pi.precno < band.precs.size())) return E_PRECINCT;
            Prec& pr = band.precs[pi.precno];
            pr.incl.reset();
            pr.imsb.reset();
            for (auto& cb : pr.cblks) {
                cb.numsegs = 0;
                cb.real_num_segs = 0;
            }
        }
    }
    if (tp.csty & 0x02) {  // SOP
        if (max_len >= 6 && cur[0] == 0xff && cur[1] == 0x91) cur += 6;
    }
    const uint8_t* hstart;
    u32 remaining;
    u32* lenp;
    const uint8_t** startp;
    const uint8_t* local_start;
    if (hdr.packed) {
        startp = &hdr.data;
        lenp = &hdr.len;
    } else {
        local_start = cur;
        remaining = (u32)(src + max_len - cur);
        startp = &local_start;
        lenp = &remaining;
    }
    hstart = *startp;
    const uint8_t* hp = hstart;
    Bio bio;
    bio.init(hp, *lenp);
    u32 present = bio.read(1);
    bool data_present = present != 0;
    if (present) {
        for (u32 b = 0; b < res.numbands; ++b) {
            Band& band = res.bands[b];
            if (band.empty()) continue;
            Prec& pr = band.precs[pi.precno];
            u32 nb = pr.cw * pr.ch;
            for (u32 k = 0; k < nb; ++k) {
                Cblk& cb = pr.cblks[k];
                u32 included;
                if (!cb.numsegs)
                    included = tgt_decode(bio, pr.incl, k, (i32)(pi.layno + 1));
                else
                    included = bio.read(1);
                if (!included) {
                    cb.numnewpasses = 0;
                    continue;
                }
                if (!cb.numsegs) {
                    u32 i = 0;
                    while (!tgt_decode(bio, pr.imsb, k, (i32)i)) ++i;
                    cb.numbps = (u32)band.numbps + 1 - i;
                    cb.numlenbits = 3;
                }
                cb.numnewpasses = getnumpasses(bio);
                u32 inc = getcommacode(bio);
                cb.numlenbits += inc;
                u32 segno = 0;
                if (!cb.numsegs) {
                    init_seg(cb, segno, cp.cblksty, true);
                } else {
                    segno = cb.numsegs - 1;
                    if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
                        ++segno;
                        init_seg(cb, segno, cp.cblksty, false);
                    }
                }
                i32 n = (i32)cb.numnewpasses;
                do {
                    Seg& s = cb.segs[segno];
                    s.numnewpasses = (u32)imin((i32)(s.maxpasses - s.numpasses), n);
                    u32 bits = cb.numlenbits + floorlog2(s.numnewpasses);
                    if (bits > 32) return E_BITNUMBER;
                    s.newlen = bio.read(bits);
                    n -= (i32)s.numnewpasses;
                    if (n > 0) {
                        ++segno;
                        init_seg(cb, segno, cp.cblksty, false);
                    }
                } while (n > 0);
            }
        }
    }
    bio.inalign();
    hp += bio.numbytes();
    if (tp.csty & 0x04) {  // EPH: a missing one fails the tile
        if ((*lenp - (u32)(hp - hstart)) < 2U || hp[0] != 0xff ||
            hp[1] != 0x92)
            return E_EPH;
        hp += 2;
    }
    u32 hlen = (u32)(hp - hstart);
    *lenp -= hlen;
    *startp += hlen;
    if (!hdr.packed) cur = local_start;
    read = (u32)(cur - src);
    if (!data_present) return OK;
    // the packet's data
    const uint8_t* body = src + read;
    u32 body_max = max_len - read;
    u32 used = 0;
    for (u32 b = 0; b < res.numbands; ++b) {
        Band& band = res.bands[b];
        if (band.empty()) continue;
        Prec& pr = band.precs[pi.precno];
        u32 nb = pr.cw * pr.ch;
        for (u32 k = 0; k < nb; ++k) {
            Cblk& cb = pr.cblks[k];
            if (!cb.numnewpasses) continue;
            u32 segi;
            if (!cb.numsegs) {
                segi = 0;
                ++cb.numsegs;
            } else {
                segi = cb.numsegs - 1;
                if (cb.segs[segi].numpasses == cb.segs[segi].maxpasses) {
                    ++segi;
                    ++cb.numsegs;
                }
            }
            do {
                Seg& s = cb.segs[segi];
                if ((u64)used + s.newlen > body_max) return E_SEGMENT;
                if (!skip) cb.chunks.push_back({body + used, s.newlen});
                used += s.newlen;
                s.len += s.newlen;
                s.numpasses += s.numnewpasses;
                cb.numnewpasses -= s.numnewpasses;
                s.real_num_passes = s.numpasses;
                if (cb.numnewpasses > 0) {
                    ++segi;
                    ++cb.numsegs;
                }
            } while (cb.numnewpasses > 0);
            cb.real_num_segs = cb.numsegs;
        }
    }
    read += used;
    return OK;
}

// opj_tcd_is_subband_area_of_interest, for the whole tile
bool area_of_interest(const TileComp& tc, const CompParams& cp, u32 resno,
                      u32 bandno, u32 bx0, u32 by0, u32 bx1, u32 by1) {
    u32 margin = cp.qmfbid == 1 ? 2 : 3;
    u32 tcx0 = (u32)tc.x0, tcy0 = (u32)tc.y0, tcx1 = (u32)tc.x1, tcy1 = (u32)tc.y1;
    u32 nb = resno == 0 ? tc.numres - 1 : tc.numres - resno;
    u32 x0b = bandno & 1, y0b = bandno >> 1;
    auto conv0 = [&](u32 v, u32 b) -> u32 {
        if (nb == 0) return v;
        if (v <= (1U << (nb - 1)) * b) return 0;
        return uint_ceildivpow2(v - (1U << (nb - 1)) * b, nb);
    };
    u32 tbx0 = conv0(tcx0, x0b), tby0 = conv0(tcy0, y0b);
    u32 tbx1 = conv0(tcx1, x0b), tby1 = conv0(tcy1, y0b);
    tbx0 = tbx0 < margin ? 0 : tbx0 - margin;
    tby0 = tby0 < margin ? 0 : tby0 - margin;
    auto adds = [](u32 a, u32 b) -> u32 {
        u64 s = (u64)a + b;
        return s > 0xFFFFFFFFULL ? 0xFFFFFFFFU : (u32)s;
    };
    tbx1 = adds(tbx1, margin);
    tby1 = adds(tby1, margin);
    return bx0 < tbx1 && by0 < tby1 && bx1 > tbx0 && by1 > tby0;
}

int t2_decode(const TileParams& tp, std::vector<TileComp>& comps,
              const uint8_t* data, u32 len, Headers& hdr) {
    PiShared sh;
    u32 max_res, max_prec;
    int st = pi_create(tp, sh, max_res, max_prec);
    if (st) return st;
    u32 npocs = tp.poc ? (u32)tp.pocs.size() : 1;
    const uint8_t* cur = data;
    u32 max_len = len;
    for (u32 pino = 0; pino < npocs; ++pino) {
        Iter it;
        it.sh = &sh;
        it.numcomps = tp.numcomps;
        it.state = 0;
        it.l = it.r = it.c = it.p = it.yy = it.xx = it.lim_r = 0;
        PacketIterator& pi = it.pi;
        pi.layno0 = 0;
        pi.precno0 = 0;
        pi.precno1 = max_prec;
        if (tp.poc) {
            const Poc& p = tp.pocs[pino];
            pi.poc = p;
            pi.poc.layno1 = umin(p.layno1, tp.numlayers);
        } else {
            pi.poc.prg = tp.prg;
            pi.poc.resno0 = 0;
            pi.poc.compno0 = 0;
            pi.poc.resno1 = max_res;
            pi.poc.compno1 = tp.numcomps;
            pi.poc.layno1 = tp.numlayers;
        }
        if (pi.poc.prg == -1) return E_PROGRESSION;
        std::vector<bool> first_pass_failed(tp.numcomps, true);
        while (iter_next(it)) {
            TileComp& tc = comps[pi.compno];
            bool skip = false;
            if (pi.layno >= tp.numlayers) {
                skip = true;
            } else if (pi.resno >= tc.numres) {
                skip = true;
            } else {
                Res& res = tc.res[pi.resno];
                skip = true;
                for (u32 b = 0; b < res.numbands; ++b) {
                    Band& band = res.bands[b];
                    if (!(pi.precno < band.precs.size())) {
                        if (!band.empty()) return E_PRECINCT;
                        continue;
                    }
                    Prec& pr = band.precs[pi.precno];
                    if (area_of_interest(tc, tp.comps[pi.compno], pi.resno,
                                         band.bandno, (u32)pr.x0, (u32)pr.y0,
                                         (u32)pr.x1, (u32)pr.y1)) {
                        skip = false;
                        break;
                    }
                }
            }
            u32 nread = 0;
            if (!skip) first_pass_failed[pi.compno] = false;
            st = decode_packet(tp, comps, pi, cur, max_len, hdr, skip, nread);
            if (st) return st;
            if (!skip)
                tc.resno_decoded = umax(pi.resno, tc.resno_decoded);
            if (first_pass_failed[pi.compno] && tc.resno_decoded == 0)
                tc.resno_decoded = tc.numres - 1;
            cur += nread;
            max_len -= nread;
        }
    }
    return OK;
}


// ------------------------------------------------------------ MQ decoder

struct MqState {
    u32 qe;
    uint8_t nmps, nlps, swtch;
};
const MqState MQ[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

enum { CTX_ZC = 0, CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18,
       NUM_CTX = 19 };

struct Mq {
    const uint8_t* bp;  // the segment, followed by 0xFF 0xFF
    u32 a, c, ct;
    uint8_t st[NUM_CTX], mps[NUM_CTX];

    void reset_states() {
        std::memset(st, 0, sizeof(st));
        std::memset(mps, 0, sizeof(mps));
        st[CTX_UNI] = 46;
        st[CTX_AGG] = 3;
        st[CTX_ZC] = 4;
    }
    void bytein() {
        u32 next = bp[1];
        if (*bp == 0xff) {
            if (next > 0x8f) {
                c += 0xff00;
                ct = 8;
            } else {
                bp++;
                c += next << 9;
                ct = 7;
            }
        } else {
            bp++;
            c += next << 8;
            ct = 8;
        }
    }
    void init(const uint8_t* p, u32 len) {
        bp = p;
        c = len == 0 ? (0xffU << 16) : ((u32)*bp << 16);
        bytein();
        c <<= 7;
        ct -= 7;
        a = 0x8000;
    }
    void raw_init(const uint8_t* p) {
        bp = p;
        c = 0;
        ct = 0;
    }
    void renorm() {
        do {
            if (ct == 0) bytein();
            a <<= 1;
            c <<= 1;
            ct--;
        } while (a < 0x8000);
    }
    u32 decode(int cx) {
        const MqState& s = MQ[st[cx]];
        u32 qe = s.qe, d;
        a -= qe;
        if ((c >> 16) < qe) {
            if (a < qe) {
                a = qe;
                d = mps[cx];
                st[cx] = s.nmps;
            } else {
                a = qe;
                d = !mps[cx];
                if (s.swtch) mps[cx] = !mps[cx];
                st[cx] = s.nlps;
            }
            renorm();
        } else {
            c -= qe << 16;
            if ((a & 0x8000) == 0) {
                if (a < qe) {
                    d = !mps[cx];
                    if (s.swtch) mps[cx] = !mps[cx];
                    st[cx] = s.nlps;
                } else {
                    d = mps[cx];
                    st[cx] = s.nmps;
                }
                renorm();
            } else {
                d = mps[cx];
            }
        }
        return d;
    }
    u32 raw_decode() {
        if (ct == 0) {
            if (c == 0xff) {
                if (*bp > 0x8f) {
                    c = 0xff;
                    ct = 8;
                } else {
                    c = *bp;
                    bp++;
                    ct = 7;
                }
            } else {
                c = *bp;
                bp++;
                ct = 8;
            }
        }
        ct--;
        return (c >> ct) & 1U;
    }
};

// ------------------------------------------------------------ tier 1

// flag bits of a sample: its neighbours' significance, the signs of the
// four direct neighbours, its own state
constexpr u32 F_NW = 1u << 0, F_N = 1u << 1, F_NE = 1u << 2, F_W = 1u << 3,
              F_E = 1u << 4, F_SW = 1u << 5, F_S = 1u << 6, F_SE = 1u << 7,
              F_NEIGH = 0xFFu, F_SGN_N = 1u << 8, F_SGN_S = 1u << 9,
              F_SGN_W = 1u << 10, F_SGN_E = 1u << 11, F_SIG = 1u << 12,
              F_PI = 1u << 13, F_MU = 1u << 14;

uint8_t ZC_LUT[4][256];
uint8_t SC_LUT[256];   // context
uint8_t SPB_LUT[256];  // sign predictor

struct LutInit {
    LutInit() {
        for (int o = 0; o < 4; ++o)
            for (int f = 0; f < 256; ++f) {
                int h = ((f & F_W) != 0) + ((f & F_E) != 0);
                int v = ((f & F_N) != 0) + ((f & F_S) != 0);
                int d = ((f & F_NW) != 0) + ((f & F_NE) != 0) +
                        ((f & F_SW) != 0) + ((f & F_SE) != 0);
                int n = 0;
                if (o == 1) {  // HL: horizontally high-pass
                    int t = h;
                    h = v;
                    v = t;
                }
                if (o != 3) {
                    if (!h) {
                        n = !v ? (!d ? 0 : d == 1 ? 1 : 2) : v == 1 ? 3 : 4;
                    } else if (h == 1) {
                        n = !v ? (!d ? 5 : 6) : 7;
                    } else {
                        n = 8;
                    }
                } else {
                    int hv = h + v;
                    if (!d)
                        n = !hv ? 0 : hv == 1 ? 1 : 2;
                    else if (d == 1)
                        n = !hv ? 3 : hv == 1 ? 4 : 5;
                    else if (d == 2)
                        n = !hv ? 6 : 7;
                    else
                        n = 8;
                }
                ZC_LUT[o][f] = (uint8_t)(CTX_ZC + n);
            }
        // index: bit0 N sig, 1 S sig, 2 W sig, 3 E sig, 4 N neg, 5 S neg,
        // 6 W neg, 7 E neg
        for (int f = 0; f < 256; ++f) {
            auto contrib = [&](int sig, int neg) {
                return (f >> sig & 1) ? ((f >> neg & 1) ? -1 : 1) : 0;
            };
            int e = contrib(3, 7), w = contrib(2, 6);
            int nn = contrib(0, 4), s = contrib(1, 5);
            int hc = (e > 0 || w > 0 ? 1 : 0) - (e < 0 || w < 0 ? 1 : 0);
            int vc = (nn > 0 || s > 0 ? 1 : 0) - (nn < 0 || s < 0 ? 1 : 0);
            int spb = (!hc && !vc) ? 0 : !(hc > 0 || (!hc && vc > 0));
            if (hc < 0) {
                hc = -hc;
                vc = -vc;
            }
            int n = !hc ? (vc == 0 ? 0 : 1) : (vc == -1 ? 2 : !vc ? 3 : 4);
            SC_LUT[f] = (uint8_t)(CTX_SC + n);
            SPB_LUT[f] = (uint8_t)spb;
        }
    }
} lut_init;

inline u32 sc_index(u32 f) {
    return ((f & F_N) ? 1u : 0u) | ((f & F_S) ? 2u : 0u) |
           ((f & F_W) ? 4u : 0u) | ((f & F_E) ? 8u : 0u) |
           ((f & F_SGN_N) ? 16u : 0u) | ((f & F_SGN_S) ? 32u : 0u) |
           ((f & F_SGN_W) ? 64u : 0u) | ((f & F_SGN_E) ? 128u : 0u);
}

struct T1 {
    u32 w, h, fs;  // fs: the flag rows' stride (w + 2)
    std::vector<i32> data;
    std::vector<u32> flags;
    bool vsc;
    int orient;
    Mq mq;

    u32* fl(u32 x, u32 y) { return &flags[(size_t)(y + 1) * fs + x + 1]; }

    void set_sig(u32 x, u32 y, u32 neg) {
        u32* f = fl(x, y);
        *f |= F_SIG;
        f[-1] |= F_E | (neg ? F_SGN_E : 0);
        f[1] |= F_W | (neg ? F_SGN_W : 0);
        if (!((y & 3) == 0 && vsc)) {
            u32* n = f - fs;
            *n |= F_S | (neg ? F_SGN_S : 0);
            n[-1] |= F_SE;
            n[1] |= F_SW;
        }
        u32* s = f + fs;
        *s |= F_N | (neg ? F_SGN_N : 0);
        s[-1] |= F_NE;
        s[1] |= F_NW;
    }

    void sign(u32 x, u32 y, bool raw, i32 oneplushalf) {
        u32 v;
        if (raw) {
            v = mq.raw_decode();
        } else {
            u32 idx = sc_index(*fl(x, y));
            v = mq.decode(SC_LUT[idx]) ^ SPB_LUT[idx];
        }
        data[(size_t)y * w + x] = v ? -oneplushalf : oneplushalf;
        set_sig(x, y, v);
    }

    void sigpass(i32 bpno, bool raw) {
        i32 one = 1 << bpno, half = one >> 1, oneplushalf = one | half;
        for (u32 k = 0; k < h; k += 4)
            for (u32 x = 0; x < w; ++x)
                for (u32 y = k; y < k + 4 && y < h; ++y) {
                    u32 f = *fl(x, y);
                    if ((f & (F_SIG | F_PI)) == 0 && (f & F_NEIGH)) {
                        u32 v = raw ? mq.raw_decode()
                                    : mq.decode(ZC_LUT[orient][f & F_NEIGH]);
                        if (v) sign(x, y, raw, oneplushalf);
                        *fl(x, y) |= F_PI;
                    }
                }
    }

    void refpass(i32 bpno, bool raw) {
        i32 one = 1 << bpno, poshalf = one >> 1;
        for (u32 k = 0; k < h; k += 4)
            for (u32 x = 0; x < w; ++x)
                for (u32 y = k; y < k + 4 && y < h; ++y) {
                    u32* f = fl(x, y);
                    if ((*f & (F_SIG | F_PI)) == F_SIG) {
                        u32 v;
                        if (raw) {
                            v = mq.raw_decode();
                        } else {
                            int cx = (*f & F_MU) ? CTX_MAG + 2
                                     : (*f & F_NEIGH) ? CTX_MAG + 1
                                                      : CTX_MAG;
                            v = mq.decode(cx);
                        }
                        i32& d = data[(size_t)y * w + x];
                        d += (v ^ (d < 0 ? 1u : 0u)) ? poshalf : -poshalf;
                        *f |= F_MU;
                    }
                }
    }

    void clnpass_step(u32 x, u32 y, i32 oneplushalf, bool partial) {
        if (!partial) {
            u32 f = *fl(x, y);
            if (!mq.decode(ZC_LUT[orient][f & F_NEIGH])) return;
        }
        sign(x, y, false, oneplushalf);
    }

    void clnpass(i32 bpno, bool segsym) {
        i32 one = 1 << bpno, half = one >> 1, oneplushalf = one | half;
        const u32 busy = F_NEIGH | F_SIG | F_PI | F_MU;
        u32 k = 0;
        for (; k + 4 <= h; k += 4)
            for (u32 x = 0; x < w; ++x) {
                bool quiet = true;
                for (u32 y = k; y < k + 4; ++y)
                    if (*fl(x, y) & busy) quiet = false;
                if (quiet) {
                    if (!mq.decode(CTX_AGG)) continue;
                    u32 runlen = mq.decode(CTX_UNI);
                    runlen = (runlen << 1) | mq.decode(CTX_UNI);
                    clnpass_step(x, k + runlen, oneplushalf, true);
                    for (u32 y = k + runlen + 1; y < k + 4; ++y)
                        clnpass_step(x, y, oneplushalf, false);
                } else {
                    for (u32 y = k; y < k + 4; ++y)
                        if (!(*fl(x, y) & (F_SIG | F_PI)))
                            clnpass_step(x, y, oneplushalf, false);
                }
                for (u32 y = k; y < k + 4; ++y) *fl(x, y) &= ~F_PI;
            }
        if (k < h)
            for (u32 x = 0; x < w; ++x) {
                for (u32 y = k; y < h; ++y)
                    if (!(*fl(x, y) & (F_SIG | F_PI)))
                        clnpass_step(x, y, oneplushalf, false);
                for (u32 y = k; y < h; ++y) *fl(x, y) &= ~F_PI;
            }
        if (segsym) {
            for (int i = 0; i < 4; ++i) mq.decode(CTX_UNI);
        }
    }
};

// opj_t1_decode_cblk: the code-block's coefficients into t1.data
int decode_cblk(T1& t1, const Cblk& cb, u32 orient, u32 roishift,
                u32 cblksty, std::vector<uint8_t>& segbuf) {
    t1.w = (u32)(cb.x1 - cb.x0);
    t1.h = (u32)(cb.y1 - cb.y0);
    t1.fs = t1.w + 2;
    t1.data.assign((size_t)t1.w * t1.h, 0);
    t1.flags.assign((size_t)(t1.w + 2) * (t1.h + 2), 0);
    t1.vsc = (cblksty & 0x08) != 0;
    t1.orient = (int)orient;
    i32 bpno_plus_one = (i32)(roishift + cb.numbps);
    if (bpno_plus_one >= 31) return E_BPNO;
    u32 passtype = 2;
    t1.mq.reset_states();
    if (cb.chunks.empty()) return OK;
    // the code-block's bytes, each segment followed by 0xFF 0xFF as
    // openjpeg's synthetic marker
    size_t total = 0;
    for (const Chunk& ch : cb.chunks) total += ch.len;
    std::vector<uint8_t> all(total);
    size_t at = 0;
    for (const Chunk& ch : cb.chunks) {
        if (ch.len) std::memcpy(&all[at], ch.data, ch.len);
        at += ch.len;
    }
    size_t idx = 0;
    for (u32 segno = 0; segno < cb.real_num_segs; ++segno) {
        const Seg& seg = cb.segs[segno];
        bool raw = (bpno_plus_one <= (i32)cb.numbps - 4) && passtype < 2 &&
                   (cblksty & 0x01);
        segbuf.assign((size_t)seg.len + 2, 0xFF);
        size_t avail = idx < total ? total - idx : 0;
        size_t n = seg.len < avail ? seg.len : avail;
        if (n) std::memcpy(segbuf.data(), &all[idx], n);
        idx += seg.len;
        if (raw)
            t1.mq.raw_init(segbuf.data());
        else
            t1.mq.init(segbuf.data(), seg.len);
        for (u32 passno = 0; passno < seg.real_num_passes && bpno_plus_one >= 1;
             ++passno) {
            if (passtype == 0)
                t1.sigpass(bpno_plus_one, raw);
            else if (passtype == 1)
                t1.refpass(bpno_plus_one, raw);
            else
                t1.clnpass(bpno_plus_one, (cblksty & 0x20) != 0);
            if ((cblksty & 0x02) && !raw) t1.mq.reset_states();
            if (++passtype == 3) {
                passtype = 0;
                bpno_plus_one--;
            }
        }
    }
    return OK;
}

inline float i2f(i32 v) {
    float f;
    std::memcpy(&f, &v, 4);
    return f;
}
inline i32 f2i(float f) {
    i32 v;
    std::memcpy(&v, &f, 4);
    return v;
}

int t1_decode(const TileParams& tp, std::vector<TileComp>& comps) {
    T1 t1;
    std::vector<uint8_t> segbuf;
    for (u32 c = 0; c < tp.numcomps; ++c) {
        TileComp& tc = comps[c];
        const CompParams& cp = tp.comps[c];
        size_t tw = tc.w();
        tc.data.assign(tw * tc.h(), 0);
        for (u32 r = 0; r < tc.numres; ++r) {
            Res& res = tc.res[r];
            for (u32 b = 0; b < res.numbands; ++b) {
                Band& band = res.bands[b];
                for (Prec& pr : band.precs)
                    for (Cblk& cb : pr.cblks) {
                        int st = decode_cblk(t1, cb, band.bandno, cp.roishift,
                                             cp.cblksty, segbuf);
                        if (st) return st;
                        i32 x = cb.x0 - band.x0, y = cb.y0 - band.y0;
                        if (band.bandno & 1) x += tc.res[r - 1].x1 - tc.res[r - 1].x0;
                        if (band.bandno & 2) y += tc.res[r - 1].y1 - tc.res[r - 1].y0;
                        u32 w = t1.w, h = t1.h;
                        std::vector<i32>& d = t1.data;
                        if (cp.roishift) {
                            if (cp.roishift >= 31) {
                                std::fill(d.begin(), d.end(), 0);
                            } else {
                                i32 thresh = 1 << cp.roishift;
                                for (i32& v : d) {
                                    i32 mag = v < 0 ? (i32)(0u - (u32)v) : v;
                                    if (mag >= thresh) {
                                        mag >>= cp.roishift;
                                        v = v < 0 ? -mag : mag;
                                    }
                                }
                            }
                        }
                        i32* out = &tc.data[(size_t)y * tw + x];
                        if (cp.qmfbid == 1) {
                            for (u32 j = 0; j < h; ++j)
                                for (u32 i = 0; i < w; ++i)
                                    out[j * tw + i] = d[(size_t)j * w + i] / 2;
                        } else {
                            const float stepsize = 0.5f * band.stepsize;
                            for (u32 j = 0; j < h; ++j)
                                for (u32 i = 0; i < w; ++i)
                                    out[j * tw + i] =
                                        f2i((float)d[(size_t)j * w + i] * stepsize);
                        }
                    }
            }
        }
    }
    return OK;
}

// ------------------------------------------------------------ wavelets

void idwt53_1d(i32* x, u32 len, u32 cas) {
    if (cas == 0) {
        if (len <= 1) return;
    } else {
        if (len == 1) {
            x[0] /= 2;
            return;
        }
        if (len == 0) return;
    }
    for (u32 p = cas; p < len; p += 2) {
        i32 l = p >= 1 ? x[p - 1] : x[p + 1];
        i32 r = p + 1 < len ? x[p + 1] : x[p - 1];
        x[p] = (i32)((u32)x[p] - (u32)(wrap_add(wrap_add(l, r), 2) >> 2));
    }
    for (u32 p = 1 - cas; p < len; p += 2) {
        i32 l = p >= 1 ? x[p - 1] : x[p + 1];
        i32 r = p + 1 < len ? x[p + 1] : x[p - 1];
        x[p] = wrap_add(x[p], wrap_add(l, r) >> 1);
    }
}

const float K97 = 1.230174105f;
const float TWO_INVK = 1.625732422f;
const float ALPHA = -1.586134342f, BETA = -0.052980118f,
            GAMMA = 0.882911075f, DELTA = 0.443506852f;

inline void lift97(float* x, u32 len, u32 start, float c) {
    for (u32 p = start; p < len; p += 2) {
        float l = p >= 1 ? x[p - 1] : x[p + 1];
        float r = p + 1 < len ? x[p + 1] : x[p - 1];
        x[p] = x[p] + (l + r) * c;
    }
}

void idwt97_1d(float* x, u32 sn, u32 dn, u32 cas) {
    u32 len = sn + dn;
    if (cas == 0) {
        if (!(dn > 0 || sn > 1)) return;
    } else {
        if (!(sn > 0 || dn > 1)) return;
    }
    u32 a = cas, b = 1 - cas;
    for (u32 p = a; p < len; p += 2) x[p] = x[p] * K97;
    for (u32 p = b; p < len; p += 2) x[p] = x[p] * TWO_INVK;
    lift97(x, len, a, -DELTA);
    lift97(x, len, b, -GAMMA);
    lift97(x, len, a, -BETA);
    lift97(x, len, b, -ALPHA);
}

void idwt(TileComp& tc, u32 numres, bool reversible) {
    if (numres <= 1) return;
    size_t w = tc.w();
    u32 rw = (u32)(tc.res[0].x1 - tc.res[0].x0);
    u32 rh = (u32)(tc.res[0].y1 - tc.res[0].y0);
    const u32 COLS = 16;
    std::vector<i32> li, gi;
    std::vector<float> lf, gf;
    for (u32 r = 1; r < numres; ++r) {
        const Res& res = tc.res[r];
        u32 hsn = rw, vsn = rh;
        rw = (u32)(res.x1 - res.x0);
        rh = (u32)(res.y1 - res.y0);
        u32 hdn = rw - hsn, vdn = rh - vsn;
        u32 hcas = (u32)(res.x0 % 2), vcas = (u32)(res.y0 % 2);
        li.resize(rw);
        lf.resize(rw);
        // rows
        for (u32 j = 0; j < rh; ++j) {
            i32* row = &tc.data[(size_t)j * w];
            if (reversible) {
                for (u32 i = 0; i < hsn; ++i) li[2 * i + hcas] = row[i];
                for (u32 i = 0; i < hdn; ++i) li[2 * i + 1 - hcas] = row[hsn + i];
                idwt53_1d(li.data(), rw, hcas);
                std::memcpy(row, li.data(), rw * sizeof(i32));
            } else {
                for (u32 i = 0; i < hsn; ++i) lf[2 * i + hcas] = i2f(row[i]);
                for (u32 i = 0; i < hdn; ++i) lf[2 * i + 1 - hcas] = i2f(row[hsn + i]);
                idwt97_1d(lf.data(), hsn, hdn, hcas);
                for (u32 i = 0; i < rw; ++i) row[i] = f2i(lf[i]);
            }
        }
        // columns, COLS at a time: a group's samples are gathered and
        // scattered a row at a time, so each pass walks the rows once
        for (u32 i0 = 0; i0 < rw; i0 += COLS) {
            u32 g = rw - i0 < COLS ? rw - i0 : COLS;
            if (reversible) {
                gi.resize((size_t)COLS * rh);
                for (u32 j = 0; j < rh; ++j) {
                    u32 at = j < vsn ? 2 * j + vcas : 2 * (j - vsn) + 1 - vcas;
                    const i32* src = &tc.data[(size_t)j * w + i0];
                    for (u32 k = 0; k < g; ++k) gi[(size_t)k * rh + at] = src[k];
                }
                for (u32 k = 0; k < g; ++k) idwt53_1d(&gi[(size_t)k * rh], rh, vcas);
                for (u32 j = 0; j < rh; ++j) {
                    i32* dst = &tc.data[(size_t)j * w + i0];
                    for (u32 k = 0; k < g; ++k) dst[k] = gi[(size_t)k * rh + j];
                }
            } else {
                gf.resize((size_t)COLS * rh);
                for (u32 j = 0; j < rh; ++j) {
                    u32 at = j < vsn ? 2 * j + vcas : 2 * (j - vsn) + 1 - vcas;
                    const i32* src = &tc.data[(size_t)j * w + i0];
                    for (u32 k = 0; k < g; ++k) gf[(size_t)k * rh + at] = i2f(src[k]);
                }
                for (u32 k = 0; k < g; ++k)
                    idwt97_1d(&gf[(size_t)k * rh], vsn, vdn, vcas);
                for (u32 j = 0; j < rh; ++j) {
                    i32* dst = &tc.data[(size_t)j * w + i0];
                    for (u32 k = 0; k < g; ++k) dst[k] = f2i(gf[(size_t)k * rh + j]);
                }
            }
        }
    }
}

int mct_decode(const TileParams& tp, std::vector<TileComp>& comps) {
    if (!tp.mct) return OK;
    if (tp.numcomps < 3) return OK;  // openjpeg skips it
    TileComp &c0 = comps[0], &c1 = comps[1], &c2 = comps[2];
    const Res& full0 = c0.res[c0.numres - 1];
    size_t n = (size_t)(full0.x1 - full0.x0) * (size_t)(full0.y1 - full0.y0);
    if (c0.numres != c1.numres || c0.numres != c2.numres) return E_MCT;
    auto area = [](const TileComp& t) {
        const Res& r = t.res[t.resno_decoded];
        return (size_t)(r.x1 - r.x0) * (size_t)(r.y1 - r.y0);
    };
    if (c0.resno_decoded != c1.resno_decoded ||
        c0.resno_decoded != c2.resno_decoded || area(c1) != n || area(c2) != n)
        return E_MCT;
    i32 *d0 = c0.data.data(), *d1 = c1.data.data(), *d2 = c2.data.data();
    if (tp.comps[0].qmfbid == 1) {
        for (size_t i = 0; i < n; ++i) {
            i32 y = d0[i], u = d1[i], v = d2[i];
            i32 g = (i32)((u32)y - (u32)(wrap_add(u, v) >> 2));
            d0[i] = wrap_add(v, g);
            d1[i] = g;
            d2[i] = wrap_add(u, g);
        }
    } else {
        for (size_t i = 0; i < n; ++i) {
            float y = i2f(d0[i]), u = i2f(d1[i]), v = i2f(d2[i]);
            float r = y + (v * 1.402f);
            float g = y - (u * 0.34413f) - (v * (0.71414f));
            float b = y + (u * 1.772f);
            d0[i] = f2i(r);
            d1[i] = f2i(g);
            d2[i] = f2i(b);
        }
    }
    return OK;
}

// the bytes opj_tcd_update_tile_data gives a sample of `prec` bits
size_t sample_bytes(u32 prec) {
    size_t n = (prec + 7) >> 3;
    return n == 3 ? 4 : n;
}

void dc_shift(const CompParams& cp, TileComp& tc) {
    const Res& r = tc.res[tc.resno_decoded];
    u32 width = (u32)(r.x1 - r.x0), height = (u32)(r.y1 - r.y0);
    size_t w = tc.w();
    i32 lo, hi;
    if (cp.sgnd) {
        lo = -(1 << (cp.prec - 1));
        hi = (1 << (cp.prec - 1)) - 1;
    } else {
        lo = 0;
        hi = (i32)((1U << cp.prec) - 1);
    }
    i32 shift = cp.dc_shift;
    for (u32 j = 0; j < height; ++j)
        for (u32 i = 0; i < width; ++i) {
            i32& v = tc.data[(size_t)j * w + i];
            if (cp.qmfbid == 1) {
                i32 s = wrap_add(v, shift);
                v = s < lo ? lo : s > hi ? hi : s;
            } else {
                float f = i2f(v);
                if (f > (float)INT32_MAX) {
                    v = hi;
                } else if (f < (float)INT32_MIN) {
                    v = lo;
                } else if (std::isnan(f)) {
                    v = lo;  // cvtss2si gives INT64_MIN
                } else {
                    i64 s = (i64)std::nearbyint(f) + shift;
                    v = (i32)(s < lo ? lo : s > hi ? hi : s);
                }
            }
        }
}

}  // namespace

// params: tile x0, y0, x1, y1, numcomps, progression (-1 unknown), layers,
// mct, Scod, POC in use, number of POC entries, then 6 a POC entry
// (resno0, compno0, layno1, resno1, compno1, order), then for each
// component dx, dy, prec, sgnd, resolutions, cblkw, cblkh, code-block
// style, qmfbid, qntsty, guard bits, roishift, DC level shift, 33
// precinct width and 33
// height exponents, 97 step exponents and 97 mantissas.
// hdr: the packed packet headers (PPM's, still unread, or the tile's PPT)
// where hdr_len >= 0; *hdr_used: the bytes the tile's packets took.
// out: the tile as opj_tcd_update_tile_data leaves it, out_len bytes:
// each component at the resolution decoded, one after another, a sample in
// 1, 2 or 4 little-endian bytes by its precision (its low bytes).
extern "C" int ecgmm_j2k_tile(const uint8_t* data, int64_t len,
                              const uint8_t* hdr, int64_t hdr_len,
                              int64_t* hdr_used, const int64_t* params,
                              int64_t nparams, uint8_t* out, int64_t out_len) {
    if (nparams < 11) return E_PARAMS;
    TileParams tp;
    const int64_t* q = params;
    tp.x0 = (i32)q[0];
    tp.y0 = (i32)q[1];
    tp.x1 = (i32)q[2];
    tp.y1 = (i32)q[3];
    tp.numcomps = (u32)q[4];
    tp.prg = (int)q[5];
    tp.numlayers = (u32)q[6];
    tp.mct = (u32)q[7];
    tp.csty = (u32)q[8];
    tp.poc = q[9] != 0;
    i64 npoc = q[10];
    const int64_t per_comp = 13 + 2 * MAXRLVLS + 2 * MAXBANDS;
    if (nparams != 11 + 6 * npoc + per_comp * (i64)tp.numcomps) return E_PARAMS;
    q += 11;
    for (i64 i = 0; i < npoc; ++i, q += 6)
        tp.pocs.push_back({(u32)q[0], (u32)q[1], (u32)q[2], (u32)q[3],
                           (u32)q[4], (int)q[5]});
    tp.comps.resize(tp.numcomps);
    for (u32 c = 0; c < tp.numcomps; ++c) {
        CompParams& cp = tp.comps[c];
        cp.dx = (u32)q[0];
        cp.dy = (u32)q[1];
        cp.prec = (u32)q[2];
        cp.sgnd = (u32)q[3];
        cp.numres = (u32)q[4];
        cp.cblkw = (u32)q[5];
        cp.cblkh = (u32)q[6];
        cp.cblksty = (u32)q[7];
        cp.qmfbid = (u32)q[8];
        cp.qntsty = (u32)q[9];
        cp.numgbits = (u32)q[10];
        cp.roishift = (u32)q[11];
        cp.dc_shift = (i32)q[12];
        q += 13;
        for (int i = 0; i < MAXRLVLS; ++i) cp.prcw[i] = (u32)q[i];
        q += MAXRLVLS;
        for (int i = 0; i < MAXRLVLS; ++i) cp.prch[i] = (u32)q[i];
        q += MAXRLVLS;
        for (int i = 0; i < MAXBANDS; ++i) cp.expn[i] = (i32)q[i];
        q += MAXBANDS;
        for (int i = 0; i < MAXBANDS; ++i) cp.mant[i] = (i32)q[i];
        q += MAXBANDS;
        if (cp.numres < 1 || cp.numres > (u32)MAXRLVLS || cp.dx < 1 || cp.dy < 1)
            return E_PARAMS;
    }
    std::vector<TileComp> comps;
    int st = init_tile(tp, comps);
    if (st) return st;
    size_t need = 0;
    for (u32 c = 0; c < tp.numcomps; ++c)
        need += comps[c].w() * comps[c].h() * sample_bytes(tp.comps[c].prec);
    if ((int64_t)need > out_len) return E_PARAMS;
    Headers h;
    h.packed = hdr_len >= 0;
    h.data = hdr;
    h.len = h.packed ? (u32)hdr_len : 0;
    st = t2_decode(tp, comps, data, (u32)len, h);
    if (h.packed) *hdr_used = hdr_len - (int64_t)h.len;
    if (st) return st;
    st = t1_decode(tp, comps);
    if (st) return st;
    for (u32 c = 0; c < tp.numcomps; ++c)
        idwt(comps[c], comps[c].resno_decoded + 1, tp.comps[c].qmfbid == 1);
    st = mct_decode(tp, comps);
    if (st) return st;
    size_t at = 0;
    for (u32 c = 0; c < tp.numcomps; ++c) {
        TileComp& tc = comps[c];
        dc_shift(tp.comps[c], tc);
        const Res& r = tc.res[tc.resno_decoded];
        u32 rw = (u32)(r.x1 - r.x0), rh = (u32)(r.y1 - r.y0);
        size_t w = tc.w(), n = sample_bytes(tp.comps[c].prec);
        for (u32 j = 0; j < rh; ++j) {
            const i32* src = &tc.data[(size_t)j * w];
            uint8_t* dst = out + at + (size_t)j * rw * n;
            for (u32 i = 0; i < rw; ++i)
                for (size_t k = 0; k < n; ++k)
                    dst[i * n + k] = (uint8_t)((u32)src[i] >> (8 * k));
        }
        at += (size_t)rw * rh * n;
    }
    return OK;
}

// The MQ decoder alone: n decisions of context 0, which starts in state
// `state` with MPS 0, from `data` (len bytes; the 0xFF 0xFF marker that
// ends each segment is appended here), one a byte into `out`.
extern "C" int ecgmm_j2k_mq_decode(const uint8_t* data, int64_t len,
                                   int64_t n, int state, uint8_t* out) {
    if (len < 0 || n < 0 || state < 0 || state > 46) return E_PARAMS;
    std::vector<uint8_t> buf((size_t)len + 2, 0xFF);
    if (len) std::memcpy(buf.data(), data, (size_t)len);
    Mq mq;
    mq.reset_states();
    mq.st[0] = (uint8_t)state;
    mq.init(buf.data(), (u32)len);
    for (int64_t i = 0; i < n; ++i) out[i] = (uint8_t)mq.decode(0);
    return OK;
}

// One line of the inverse 5/3 wavelet: x holds the sn low-pass then the
// dn high-pass coefficients of a line whose first sample lies on an odd
// coordinate where cas is 1; on return, the samples in order.
extern "C" int ecgmm_j2k_idwt53_line(int32_t* x, int64_t sn, int64_t dn,
                                     int cas) {
    if (sn < 0 || dn < 0 || (cas != 0 && cas != 1)) return E_PARAMS;
    std::vector<i32> line((size_t)(sn + dn));
    for (int64_t i = 0; i < sn; ++i) line[2 * i + cas] = x[i];
    for (int64_t i = 0; i < dn; ++i) line[2 * i + 1 - cas] = x[sn + i];
    idwt53_1d(line.data(), (u32)(sn + dn), (u32)cas);
    std::memcpy(x, line.data(), line.size() * sizeof(i32));
    return OK;
}
